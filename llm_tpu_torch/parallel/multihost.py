"""Multi-controller serving on torch.distributed: joining a world, its
mesh, and continuous batching across hosts.

The counterpart of `llm_tpu/parallel/multihost.py`.

- `initialize()` joins the process group (`dist.init_process_group` over
  `tcp://<coordinator>`, or torch's `env://` variables for what is left
  out) and sets the rank's card. The backend follows the device: `nccl`
  on the card, `gloo` on the CPU; it is never switched. Two ranks on one
  card under `nccl` raise before any collective.
- `multihost_mesh()` builds the ("data", "model") mesh with `model` the
  ranks of one node by default (the counterpart of the local device
  count), so tensor parallelism stays on NVLink and `data` spans nodes.

A host of the JAX package is one process that drives its local devices.
Here a process is one card, so a host is a `model` row of ranks (the
ranks at one `data` index); with `model` 1 a host is one rank. The row's
leader (`model` index 0) owns the HTTP endpoint and the request queue;
the other ranks of the row run the same engine calls on the leader's
requests (`server._MultiHostEngineLoop` broadcasts them over the row).

Cross-host continuous batching (`MultiHostEngine`,
`MultiHostPagedEngine`): each row owns `global_streams // data` slots and
serves its own requests into them. Every rank makes the same engine calls
in the same order, and the per-step decisions (is any host prefilling or
decoding, the largest position, the sampler structure of a block, a
block's page-feasible length) are agreed through a small all-gather of
host integers. Then every rank runs its forward: a prefill chunk at the
fixed width [B_local, n_batch] whenever any host prefills (rows that
write nothing sit at their stream's frontier, or are masked), and a
decode step whenever any host decodes.

Control traffic (that all-gather, the server loop's [has_work, stop]
all-gather, the row's request broadcast) runs on gloo groups of its own
(`ControlGroups`), on host integers and pickled objects, in every world:
no device tensor and no device sync is part of it. No tensor crosses
`data`: a row samples from its own rows' logits, and under `model` > 1
the vocabulary shards are gathered over `model` only. The JAX package
replicates the per-stream scalars (n_past, write masks) over every host
(`_replicated_rows`) because its partitioner would otherwise move the
cache; a rank here indexes its own block, so that gather has nothing to
carry.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from llm_tpu_torch.loader import resolve_device
from llm_tpu_torch.models.forward import (
    decode_loop_batched,
    forward_batched,
    init_cache_batched,
    local_spec,
    unpack_decode_out,
    window_bucket,
)
from llm_tpu_torch.ops.sampling import (
    BatchedDeviceSampler,
    batched_sampler,
    collect_mu,
    ensure_value_keys,
    penalty_state,
    store_mu,
)
from llm_tpu_torch.parallel import collectives_audit
from llm_tpu_torch.parallel.sharding import MeshConfig, make_mesh
from llm_tpu_torch.serve import Engine

# seconds a control collective (and the world's default group) waits for
# its peers before it fails
CONTROL_TIMEOUT_S = 600.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Join the world (call before the model loads, in every process).

    `coordinator_address` host:port of rank 0's store (`tcp://`);
    `num_processes` and `process_id` the world size and this rank. What is
    left as None comes from torch's `env://` variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK). The backend follows the device:
    `nccl` on the card, `gloo` on the CPU (`device="cpu"`). Under `nccl`
    each rank of a node takes its own card (set before any NCCL call);
    more ranks on a node than cards raise."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    world = num_processes
    if world is None:
        world = int(os.environ.get("WORLD_SIZE", "-1"))
    rank = process_id
    if rank is None:
        rank = int(os.environ.get("RANK", "-1"))
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
    hosts = host_names()
    if backend == "nccl":
        try:
            card = card_for(hosts, dist.get_rank(),
                            torch.cuda.device_count())
        except RuntimeError:
            dist.destroy_process_group()
            raise
        torch.cuda.set_device(card)


_WORLD: dict = {}


def _world_cache() -> dict:
    """The current world's cached host names and control groups. They are
    dropped once another world has taken its place (a process that
    destroys its world and joins a new one); the old world's group object
    is held, so the identity compared here is never reused."""
    if _WORLD.get("world") is not dist.group.WORLD:
        _WORLD.clear()
        _WORLD.update(world=dist.group.WORLD, hosts=None, groups={})
    return _WORLD


def host_names() -> list:
    """Every rank's host name, in rank order (an all-gather over a gloo
    group, once a world)."""
    cache = _world_cache()
    if cache["hosts"] is None:
        group = dist.new_group(backend="gloo", timeout=datetime.timedelta(
            seconds=CONTROL_TIMEOUT_S))
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, socket.gethostname(), group=group)
        cache["hosts"] = names
    return cache["hosts"]


def card_for(hosts: list, rank: int, n_cards: int) -> int:
    """The card of `rank` under nccl: its index among the ranks of its
    host. Raises when the host has more ranks than cards: NCCL refuses
    two ranks on one card, and no backend is switched behind the
    caller's back."""
    mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    if len(mine) > n_cards:
        raise RuntimeError(
            f"rank {rank}: {len(mine)} ranks on host {hosts[rank]!r} "
            f"share {n_cards} card(s); nccl needs one card a rank (ranks "
            "that share a card need a gloo world, `launch.spawn`)")
    return mine.index(rank)


def multihost_mesh(model_parallel: Optional[int] = None,
                   device=None):
    """The world's ("data", "model") mesh: `model` within a node, `data`
    across nodes. `model_parallel` defaults to the ranks on this node,
    which keeps every tensor-parallel collective on the node's links.
    `device` is this rank's (default: its current card)."""
    world = dist.get_world_size()
    if model_parallel is None:
        hosts = host_names()
        model_parallel = hosts.count(hosts[dist.get_rank()])
    if world % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide the world's {world} ranks")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return make_mesh(MeshConfig(data=world // model_parallel,
                                model=model_parallel), device=device)


# ---------------------------------------------------------------------------
# control traffic


class ControlDesync(RuntimeError):
    """A control collective did not complete: a peer is out of step, or
    gone."""


class ControlGroups:
    """The gloo groups of a mesh's control traffic: `column`, the ranks of
    this rank's `data` column (one rank a host, as the JAX package's
    process all-gather has one entry a process), and `row`, the ranks of
    its `model` row (a host). Built by every rank in the same order, once
    a world, mesh shape and CONTROL_TIMEOUT_S (`for_mesh`). `gathers`
    and `gather_s` count the all-gathers and their host seconds."""

    def __init__(self, mesh, timeout: float):
        t = datetime.timedelta(seconds=timeout)
        self.mesh = mesh
        self.timeout = timeout
        self.rank = mesh.rank
        for name in ("column", "row"):
            axis = "data" if name == "column" else "model"
            ax = mesh.axis_names.index(axis)
            lines = np.moveaxis(mesh.devices, ax, -1).reshape(
                -1, mesh.shape[axis])
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks, backend="gloo", timeout=t)
                if mesh.rank in ranks:
                    setattr(self, name, group)
                    setattr(self, name + "_ranks", ranks)
        self.gathers = 0
        self.gather_s = 0.0

    @classmethod
    def for_mesh(cls, mesh):
        groups = _world_cache()["groups"]
        key = (tuple(mesh.shape.items()), CONTROL_TIMEOUT_S)
        if key not in groups:
            groups[key] = cls(mesh, CONTROL_TIMEOUT_S)
        return groups[key]

    @property
    def leader(self) -> bool:
        """Whether this rank leads its row (`model` index 0)."""
        return self.rank == self.row_ranks[0]

    def _failed(self, what: str, ranks: list, e: Exception) -> ControlDesync:
        return ControlDesync(
            f"rank {self.rank}: the control {what} over ranks {ranks} did "
            f"not complete within {self.timeout:.0f} s: a peer is out of "
            f"step or gone ({type(e).__name__}: {e})")

    def allgather(self, local, what: str = "all-gather") -> np.ndarray:
        """Every host's `local` int64 vector, [hosts, n] in `data` order."""
        t = torch.as_tensor(np.asarray(local, np.int64))
        n = len(self.column_ranks)
        self.gathers += 1
        if n == 1:
            return t.numpy()[None]
        collectives_audit.note_control("all-gather", self.column_ranks,
                                       n * t.numel() * 8,
                                       f"control {what} {tuple(t.shape)}")
        parts = [torch.empty_like(t) for _ in range(n)]
        t0 = time.perf_counter()
        try:
            dist.all_gather(parts, t, group=self.column)
        except Exception as e:  # noqa: BLE001 - named and raised again
            raise self._failed(f"all-gather ({what})", self.column_ranks,
                               e) from e
        self.gather_s += time.perf_counter() - t0
        return torch.stack(parts).numpy()

    def any_world(self, flags, what: str) -> np.ndarray:
        """Each of the 0/1 `flags` OR'd over the whole world: over this
        rank's row, then over its column, which then holds every row's."""
        t = torch.as_tensor(np.asarray(flags, np.int64))
        for group, ranks in ((self.row, self.row_ranks),
                             (self.column, self.column_ranks)):
            if len(ranks) == 1:
                continue
            try:
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
            except Exception as e:  # noqa: BLE001 - named and raised again
                raise self._failed(f"all-reduce ({what})", ranks, e) from e
        return t.numpy()

    def broadcast_row(self, obj):
        """The row leader's `obj` on every rank of the row (pickled)."""
        if len(self.row_ranks) == 1:
            return obj
        box = [obj]
        try:
            dist.broadcast_object_list(box, src=self.row_ranks[0],
                                       group=self.row)
        except Exception as e:  # noqa: BLE001 - named and raised again
            raise self._failed("row broadcast", self.row_ranks, e) from e
        if collectives_audit.recording():
            collectives_audit.note_control(
                "broadcast", self.row_ranks, len(pickle.dumps(box[0])),
                "control row broadcast")
        return box[0]


def _row_seed(step: int, row: int) -> int:
    """The generator seed of a block's global `row` at `step`: 63 bits
    whose low 32, all that the CPU generator keeps, depend on both."""
    digest = hashlib.blake2b(f"{step}/{row}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little") >> 1


# ---------------------------------------------------------------------------
# the agreed sampler structure of a block


def _sampler_structure_ints(per_slot) -> list:
    """A host's part of the agreed static sampler structure: [any top-p,
    any min-p, any penalty, penalty window, any tail-free, any typical,
    any top-a, mirostat kind bits, mirostat m]. Booleans and windows agree
    by max; mirostat kinds as an OR'd bitmask (bit0 kind 1, bit1 kind 2;
    both set is a mixed batch)."""
    miro_bits = 0
    for d in per_slot:
        if d is not None and d.mirostat:
            miro_bits |= 1 << (d.mirostat - 1)
    return [
        int(any(d is not None and d.kind == "sample" and d.top_p < 1.0
                for d in per_slot)),
        int(any(d is not None and d.kind == "sample" and d.min_p > 0.0
                for d in per_slot)),
        int(any(d is not None and d.has_penalties for d in per_slot)),
        # last_n <= 0 is the unbounded window: a large sentinel keeps the
        # max agreement monotone
        max(((d.penalty_last_n if d.penalty_last_n > 0 else 1 << 30)
             for d in per_slot if d is not None and d.has_penalties),
            default=0),
        int(any(d is not None and d.kind == "sample"
                and d.tail_free_z < 1.0 for d in per_slot)),
        int(any(d is not None and d.kind == "sample"
                and d.typical_p < 1.0 for d in per_slot)),
        int(any(d is not None and d.kind == "sample"
                and d.top_a != (0.0, 0.0) for d in per_slot)),
        miro_bits,
        max((d.mirostat_m for d in per_slot
             if d is not None and d.mirostat == 1), default=100),
    ]


def _logprobs_local(active) -> int:
    """A host's part of the agreed logprobs_n: the largest top-N asked
    for, or -1 when no stream wants logprobs."""
    reqs = [s.request.logprobs for _, s in active
            if s.request.logprobs is not None]
    return max(reqs) if reqs else -1


def _sampler_structure_cfg(g, col: int) -> dict:
    """The agreed BatchedDeviceSampler keywords from the gathered ints."""
    bits = int(np.bitwise_or.reduce(g[:, col + 7].astype(np.int64)))
    if bits == 3:
        raise ValueError(
            "streams mixing mirostat 1 and mirostat 2 cannot share one "
            "globally-coordinated decode block"
        )
    return {
        "any_top_p": bool(g[:, col].max()),
        "any_min_p": bool(g[:, col + 1].max()),
        "any_penalty": bool(g[:, col + 2].max()),
        "penalty_last_n": max(int(g[:, col + 3].max()), 1),
        "any_tail_free": bool(g[:, col + 4].max()),
        "any_typical": bool(g[:, col + 5].max()),
        "any_top_a": bool(g[:, col + 6].max()),
        "mirostat_kind": 2 if bits == 2 else (1 if bits == 1 else 0),
        "mirostat_m": int(g[:, col + 8].max()),
    }


def _block_ok(active) -> int:
    """1 when every decoding stream carries a device sampler without a
    flat bias (a block's precondition), else 0: agreed with the rest, so
    that a refusal raises on every rank at once."""
    return int(all(s.request.device_sampler is not None
                   and not s.request.device_sampler.bias
                   for _, s in active))


# ---------------------------------------------------------------------------
# cross-host continuous batching


class MultiHostEngine(Engine):
    """Continuous batching scheduled across hosts: one instance a rank,
    every rank over the same mesh. Each row owns the slots
    [_row0, _row0 + global_streams // data) of the global batch, holds
    their dense head-major cache (its kv heads under `model` > 1) and
    serves its own request queue into them.

    Keeps the single-host engine's host plumbing (submit, stream
    bookkeeping, the chunked-prefill state machine, the token
    postprocess); every step is coordinated across the world, so EVERY
    rank must call step / step_multi / has_work_global in the same order.
    Does not call the base constructor. Request ids are
    `data_index * 1_000_000 + k`, unique across hosts and equal across a
    row.

    `step_multi` decodes blocks with on-device sampling. Its noise is the
    counterpart of the JAX package's `PRNGKey(steps)`: each of the rank's
    global rows draws its [n_steps, V] uniforms from a torch.Generator
    seeded with the agreed step counter and the row, so a stream's draws
    depend on its global row and the step, not on its peers, and a rank
    draws only its own rows. (JAX's and torch's generators differ, so
    sampled texts differ from the JAX package's.)
    At `model` 1 a rank's block holds no collective and runs as the
    single-card CUDA graph on the card; at `model` > 1 it runs eagerly
    (`forward.EAGER_UNDER_MESH`)."""

    # a block's flat bias would need the hosts to agree on the union of
    # the biased tokens: those requests sample on the host
    supports_device_bias = False

    def __init__(self, model, mesh, global_streams: int = 8,
                 kv_dtype=torch.bfloat16, n_batch: int = 64):
        self.model = model
        self.spec = model.spec
        self.device = model.device
        self.mesh = mesh
        self.n_batch = n_batch
        self.global_streams = global_streams
        data = mesh.shape["data"]
        if global_streams % data:
            raise ValueError(f"{global_streams} streams do not split over "
                             f"{data} hosts")
        # prefill chunks run at the FIXED width n_batch on every rank;
        # n_batch | n_ctx keeps every padded chunk write inside the cache
        if model.spec.n_ctx % n_batch:
            raise ValueError(f"n_batch {n_batch} does not divide n_ctx "
                             f"{model.spec.n_ctx}")
        self.params = model.params
        if mesh.shape["model"] > 1:
            from llm_tpu_torch.parallel.sharding import shard_params

            self.params = shard_params(model.params, mesh, model.spec)
        self.max_streams = global_streams // data  # the row's slots
        self._row0 = mesh.coords["data"] * self.max_streams
        self.control = ControlGroups.for_mesh(mesh)
        self._init_device_state(kv_dtype)

        self.slots = [None] * self.max_streams
        self.pending = []
        self.finished = {}
        self._retired_events = []
        self._next_id = mesh.coords["data"] * 1_000_000  # host-unique ids
        self._eot = model.eot_token_id()
        self._steps = 0
        self.multi_blocks = 0
        self.multi_block_steps = 0
        self.multi_fallbacks = {"mixed_mirostat": 0, "tight_pool": 0,
                                "context_full": 0}
        self._loop_gen = None  # the block noise is seeded by _steps

    def _init_device_state(self, kv_dtype) -> None:
        self.cache = init_cache_batched(local_spec(self.spec, self.params),
                                        self.max_streams, kv_dtype,
                                        self.device)

    # -- coordination -------------------------------------------------------

    def _frontier_max(self) -> int:
        return max((s.prefill_pos if s.prefilling else s.n_past
                    for s in self.slots if s is not None), default=0)

    def _sync(self) -> tuple[int, int, int, int]:
        """Agree on (prefilling, decodable, largest position, work) across
        the hosts: the only cross-host traffic at decode."""
        g = self.control.allgather([
            sum(1 for s in self.slots if s is not None and s.prefilling),
            len(self._decodable()),
            self._frontier_max(),
            1 if self.has_work() else 0,
        ], "sync")
        return (int(g[:, 0].sum()), int(g[:, 1].sum()), int(g[:, 2].max()),
                int(g[:, 3].sum()))

    def has_work_global(self) -> bool:
        return self._sync()[3] > 0

    # -- stepping -----------------------------------------------------------

    @torch.no_grad()
    def _dispatch(self, ids: np.ndarray, n_past: np.ndarray, window: int,
                  write_mask: np.ndarray) -> torch.Tensor:
        """One forward of the row's slots; the logits [B_local, T, V] on
        the device, not yet read (the card runs on while the host fires
        the token events)."""
        return forward_batched(
            self.spec, self.params, torch.tensor(ids, device=self.device),
            n_past.tolist(), self.cache, window, write_mask.tolist())[0]

    def _global_prefill_chunk(self, gmax: int) -> None:
        ids = np.zeros((self.max_streams, self.n_batch), np.int64)
        n_past = np.zeros(self.max_streams, np.int32)
        mask = np.zeros(self.max_streams, bool)  # only prefilling rows write
        chunk_lens = {}
        for i, s in enumerate(self.slots):
            if s is None or not s.prefilling:
                continue
            chunk = s.prefill_queue[s.prefill_pos:
                                    s.prefill_pos + self.n_batch]
            ids[i, :len(chunk)] = chunk
            n_past[i] = s.prefill_pos
            chunk_lens[i] = len(chunk)
            mask[i] = True
        logits = self._dispatch(
            ids, n_past, window_bucket(gmax + self.n_batch, self.spec.n_ctx),
            mask)
        self._advance_chunks(chunk_lens, logits)

    def _advance_chunks(self, chunk_lens: dict, logits) -> None:
        rows = {i: logits[i, ln - 1] for i, ln in chunk_lens.items()}
        rows = {i: r.cpu().numpy() for i, r in rows.items()}
        for i, ln in chunk_lens.items():
            s = self.slots[i]
            s.prefill_pos += ln
            s.n_past = s.prefill_pos
            s.last_logits = rows[i]
            if s.prefill_pos >= len(s.prefill_queue):
                s.prefilling = False

    def _global_decode(self, gmax: int) -> list:
        ids = np.zeros((self.max_streams, 1), np.int64)
        n_past = np.zeros(self.max_streams, np.int32)
        mask = np.zeros(self.max_streams, bool)
        sampled = {}
        for i, s in self._decodable():
            tok = self._host_sample(s)
            sampled[i] = tok
            ids[i, 0] = tok
            n_past[i] = s.n_past
            mask[i] = True
        logits_dev = self._dispatch(
            ids, n_past, window_bucket(gmax + 1, self.spec.n_ctx), mask)
        return self._emit(sampled, logits_dev)

    def _emit(self, sampled: dict, logits_dev) -> list:
        """Fire the sampled tokens' events while the card computes the
        next logits (they were sampled from last_logits), then read the
        logits."""
        events, emitted = [], []
        for i, tok in sampled.items():
            s = self.slots[i]
            emitted.append((i, s))
            events.append(self._finish_token(i, s, tok, s.last_logits))
        logits = logits_dev[:, 0, :].cpu().numpy()
        for i, s in emitted:
            s.last_logits = logits[i]
        return events

    def step(self) -> list:
        """One globally-coordinated engine step. EVERY rank must call it
        in lockstep."""
        self._admit()
        events = self._drain_retired()
        self._steps += 1
        n_pref, _, gmax, _ = self._sync()
        if n_pref:
            self._global_prefill_chunk(gmax)
            events += self._drain_retired()
        _, n_dec, gmax2, _ = self._sync()
        if n_dec:
            events += self._global_decode(gmax2)
        return events

    # -- on-device blocks ---------------------------------------------------

    def _block_intent(self, active, extra: list) -> tuple:
        """The agreed facts of a block: the gathered ints [hosts, n] of
        (decodable, any sample, top-k max, largest position, *extra, the
        sampler structure, logprobs_n, block ok), and the per-slot device
        samplers."""
        per_slot = [None] * self.max_streams
        for i, s in active:
            per_slot[i] = s.request.device_sampler
        g = self.control.allgather([
            len(active),
            int(any(d is not None and d.kind == "sample" for d in per_slot)),
            max((d.top_k for d in per_slot
                 if d is not None and d.kind == "sample"), default=0),
            self._frontier_max(),
            *extra,
            *_sampler_structure_ints(per_slot),
            _logprobs_local(active),
            _block_ok(active),
        ], "block")
        if g[:, -1].min() == 0:
            bad = np.nonzero(g[:, -1] == 0)[0].tolist()
            raise ValueError(
                "multi-host step_multi requires a device_sampler without "
                f"a flat bias on every decoding stream (not so on hosts "
                f"{bad})")
        return g, per_slot

    def _block_values(self, g, per_slot, col: int):
        """The agreed BatchedDeviceSampler and this row's value tensors,
        or None when the hosts' streams mix mirostat 1 and 2 (every rank
        sees the same gathered bits, so every rank falls back)."""
        try:
            cfg = BatchedDeviceSampler(
                sample=bool(g[:, 1].max()), top_k_max=int(g[:, 2].max()),
                bias_tokens=(), **_sampler_structure_cfg(g, col))
        except ValueError:
            return None
        # built only after the agreed decision: a row whose own streams
        # mix kinds must reach the all-gather first (a local raise would
        # leave its peers waiting)
        _, values = batched_sampler(per_slot, self.max_streams, self.device)
        return cfg, ensure_value_keys(values, cfg, self.max_streams)

    def _block_noise(self, cfg, n_steps: int) -> Optional[torch.Tensor]:
        """The block's uniforms [n_steps, B_local, V] in [1e-20, 1). Global
        row g draws its [n_steps, V] from a generator seeded with the
        agreed step counter and g, so a stream's draws depend only on its
        global row and the step: not on how many blocks its peers ran,
        nor on how many hosts there are. A rank draws its own rows only.
        None for a greedy block."""
        if not cfg.sample:
            return None
        gen = torch.Generator(device=self.device)
        rows = []
        for g in range(self._row0, self._row0 + self.max_streams):
            gen.manual_seed(_row_seed(self._steps, g))
            rows.append(torch.rand((n_steps, self.spec.n_vocab),
                                   generator=gen, device=self.device))
        return torch.stack(rows, 1).clamp_min_(1e-20)

    def _sampler_state(self, cfg, active, global_max: int):
        """The block's sampler state: windowed-penalty state from the
        streams' histories (an unbounded window sized by the agreed
        largest position, so every row's state has one shape) and the
        mirostat mu carry. None when stateless."""
        st = {}
        if cfg.any_penalty:
            hist = [[] for _ in range(self.max_streams)]
            for i, s in active:
                hist[i] = s.tokens
            st.update(penalty_state(hist, cfg.penalty_last_n,
                                    self.spec.n_vocab,
                                    unbounded_floor=global_max,
                                    device=self.device))
        if cfg.mirostat_kind:
            st["mu"] = torch.from_numpy(
                collect_mu(active, self.max_streams)).to(self.device)
        return st or None

    def _finish_block(self, active, out, ret_state, lpn, n_steps) -> list:
        toks, last_logits, _, _, fstate, lp = unpack_decode_out(
            out, ret_state, lpn)
        toks, ll, n_steps, lp, fstate = self._block_result(
            toks, last_logits, n_steps, lp, fstate)
        if fstate is not None and "mu_steps" in fstate:
            store_mu(active, fstate["mu_steps"],
                     self._block_keeps(active, toks))
        return self._postprocess_multi(active, toks, ll, n_steps, lp)

    def _block_inputs(self, active):
        logits = np.zeros((self.max_streams, self.spec.n_vocab), np.float32)
        n_past = np.zeros(self.max_streams, np.int32)
        mask = np.zeros(self.max_streams, bool)
        for i, s in active:
            logits[i] = s.last_logits
            n_past[i] = s.n_past
            mask[i] = True
        return logits, n_past, mask

    @torch.no_grad()
    def step_multi(self, n_steps: int = 16) -> list:
        """Globally-coordinated on-device multi-token decode: the hosts
        agree on the block's sampler structure and largest position, then
        every rank decodes one `decode_loop_batched` block over its rows.
        Falls back to step() on every rank at once where the agreed facts
        say so (mixed mirostat, a stream at the context's end)."""
        self._admit()
        events = self._drain_retired()
        self._steps += 1
        n_pref, _, gmax, _ = self._sync()
        if n_pref:
            self._global_prefill_chunk(gmax)
            events += self._drain_retired()
        active = self._decodable()
        g, per_slot = self._block_intent(active, [])
        if int(g[:, 0].sum()) == 0:
            return events
        agreed = self._block_values(g, per_slot, 4)
        if agreed is None:
            self.multi_fallbacks["mixed_mirostat"] += 1
            return events + self.step()
        cfg, values = agreed
        lpn = int(g[:, 13].max())
        lpn = None if lpn < 0 else lpn
        gmax2 = int(g[:, 3].max())
        n_steps = min(n_steps, self.spec.n_ctx - 1 - gmax2)
        if n_steps <= 0:
            self.multi_fallbacks["context_full"] += 1
            return events + self.step()
        logits, n_past, mask = self._block_inputs(active)
        ret_state = cfg.mirostat_kind != 0
        out = decode_loop_batched(
            self.spec, self.params, logits, n_past, self.cache, n_steps,
            window_bucket(gmax2 + n_steps, self.spec.n_ctx), cfg,
            sampler_values=values,
            write_mask=torch.from_numpy(mask).to(self.device),
            penalty_state=self._sampler_state(cfg, active, gmax2),
            logprobs_n=lpn, return_state=ret_state,
            uniforms=self._block_noise(cfg, n_steps))
        return events + self._finish_block(active, out, ret_state, lpn,
                                           n_steps)

    def generate_all(self, requests, n_steps: int = 1) -> dict:
        """Submit this host's requests and step in global lockstep until
        EVERY host drains; returns local id -> text. n_steps > 1 decodes
        in coordinated on-device blocks (device samplers required)."""
        ids = [self.submit(r) for r in requests]
        while self.has_work_global():
            if n_steps > 1:
                self.step_multi(n_steps)
            else:
                self.step()
        return {rid: "".join(self.finished[rid].text) for rid in ids}


# ---------------------------------------------------------------------------
# host-local page pools under the cross-host engine
#
# Each row owns a page pool of its own kv heads: its tables address only
# its pages, and its page 0 is its own trash page. Rows that write
# nothing this dispatch (prefilling, decoding or empty slots) point at
# their stream's frontier: positions >= n_past are rewritten before they
# are read, and positions past the table go to the trash page.


class MultiHostPagedEngine(MultiHostEngine):
    """Cross-host continuous batching over row-local page pools.

    The coordination (submit, _sync, step, generate_all) is
    MultiHostEngine's; the dense slot cache becomes a pool of `n_pages`
    pages a row (default 1 + B_local * pages_per_stream), with a
    row-local allocator and page tables. The paged kernel (K4) runs every
    T=1 page pass at any `model` width: a rank's pool holds its own kv
    heads, allocated whole, so each layer's pages are contiguous. (The
    JAX package turns its kernel off under `model` > 1, where its
    partitioner splits the step.)"""

    prefix_cache = None  # the prefix cache is single-host

    def __init__(self, model, mesh, global_streams: int = 8,
                 kv_dtype="int8", n_batch: int = 64, page_size: int = 256,
                 n_pages: Optional[int] = None):
        self.page_size = page_size
        self._n_pages_requested = n_pages
        self.decode_dispatches = 0
        super().__init__(model, mesh, global_streams, kv_dtype, n_batch)

    def _init_device_state(self, kv_dtype) -> None:
        from llm_tpu_torch.paged import PageAllocator, init_paged_cache

        self.pages_per_stream = -(-self.spec.n_ctx // self.page_size)
        local_pages = self._n_pages_requested
        if local_pages is None:
            local_pages = 1 + self.max_streams * self.pages_per_stream
        self.pool = init_paged_cache(local_spec(self.spec, self.params),
                                     local_pages, self.page_size, kv_dtype,
                                     self.device)
        self.allocator = PageAllocator(local_pages)
        self.tables = np.full((self.max_streams, self.pages_per_stream),
                              PageAllocator.TRASH, np.int32)
        self.stream_pages: list[list[int]] = [
            [] for _ in range(self.max_streams)]

    # -- page bookkeeping (row-local) -----------------------------------

    def _ensure_pages(self, slot: int, last_pos: int) -> None:
        from llm_tpu_torch.paged import PageAllocator

        for j in range(last_pos // self.page_size + 1):
            if self.tables[slot, j] == PageAllocator.TRASH:
                (p,) = self.allocator.alloc(1)
                self.tables[slot, j] = p
                self.stream_pages[slot].append(p)

    def _on_slot_released(self, slot: int) -> None:
        from llm_tpu_torch.paged import PageAllocator

        self.allocator.release(self.stream_pages[slot])
        self.stream_pages[slot] = []
        self.tables[slot, :] = PageAllocator.TRASH

    def _window_pages(self, gmax: int, extra: int) -> int:
        wp = max(1, -(-(gmax + extra) // self.page_size))
        return min(wp, self.pages_per_stream)

    def _frontiers(self) -> np.ndarray:
        """Every slotted stream's write position: its frontier (rows that
        write nothing this dispatch park there)."""
        n_past = np.zeros(self.max_streams, np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                n_past[i] = s.prefill_pos if s.prefilling else s.n_past
        return n_past

    # -- dispatch ---------------------------------------------------------

    @torch.no_grad()
    def _paged_dispatch(self, ids: np.ndarray, n_past: np.ndarray,
                        wp: int) -> torch.Tensor:
        """One paged forward of the row's slots; its logits on the device.
        The tables are copied at dispatch, so a retirement in the event
        loop cannot free a page this step still writes."""
        from llm_tpu_torch.paged import paged_forward_batched

        dev = self.device
        return paged_forward_batched(
            self.spec, self.params, torch.tensor(ids, device=dev),
            torch.tensor(n_past, device=dev),
            torch.tensor(self.tables, device=dev), self.pool, wp)[0]

    def _global_prefill_chunk(self, gmax: int) -> None:
        ids = np.zeros((self.max_streams, self.n_batch), np.int64)
        n_past = self._frontiers()
        chunk_lens = {}
        for i, s in enumerate(self.slots):
            if s is None or not s.prefilling:
                continue
            chunk = s.prefill_queue[s.prefill_pos:
                                    s.prefill_pos + self.n_batch]
            try:
                self._ensure_pages(i, s.prefill_pos + len(chunk) - 1)
            except MemoryError:
                # no pages this step: the row runs as a dummy at its
                # frontier; the single-host engine's deadlock rule
                s.kv_wait = True
                others = [o for j, o in enumerate(self.slots)
                          if o is not None and j != i]
                if not others or all(o.kv_wait for o in others):
                    self._retire(s, "kv_oom", slot=i)
                continue
            s.kv_wait = False
            ids[i, :len(chunk)] = chunk
            chunk_lens[i] = len(chunk)
        logits = self._paged_dispatch(
            ids, n_past, self._window_pages(gmax, self.n_batch))
        self._advance_chunks(chunk_lens, logits)

    def _global_decode(self, gmax: int) -> list:
        ids = np.zeros((self.max_streams, 1), np.int64)
        n_past = self._frontiers()
        sampled = {}
        for i, s in self._decodable():
            tok = self._host_sample(s)
            try:
                self._ensure_pages(i, s.n_past)
            except MemoryError:
                self._retire(s, "kv_oom", slot=i)
                n_past[i] = 0
                continue
            sampled[i] = tok
            ids[i, 0] = tok
        logits_dev = self._paged_dispatch(ids, n_past,
                                          self._window_pages(gmax, 1))
        self.decode_dispatches += 1
        return self._emit(sampled, logits_dev)

    @torch.no_grad()
    def step_multi(self, n_steps: int = 16) -> list:
        """Globally-coordinated paged on-device multi-token decode: the
        hosts agree on the sampler structure, the largest position and a
        page-feasible block length (the least of every host's), the rows
        take pages covering the whole block, and every rank runs one
        `paged_decode_loop` block. A host whose pool cannot cover a
        2-step block sends every rank down the per-token path (which
        retires kv_oom streams)."""
        from llm_tpu_torch.paged import paged_decode_loop

        self._admit()
        events = self._drain_retired()
        self._steps += 1
        n_pref, _, gmax, _ = self._sync()
        if n_pref:
            self._global_prefill_chunk(gmax)
            events += self._drain_retired()
        active = self._decodable()
        g, per_slot = self._block_intent(
            active, [self._multi_feasible(active, n_steps)])
        if int(g[:, 0].sum()) == 0:
            return events
        gmax2 = int(g[:, 3].max())
        feasible = int(g[:, 4].min())
        n_steps = min(feasible, self.spec.n_ctx - 1 - gmax2)
        if n_steps <= 1:
            key = "tight_pool" if feasible <= 1 else "context_full"
            self.multi_fallbacks[key] += 1
            return events + self.step()
        agreed = self._block_values(g, per_slot, 5)
        if agreed is None:
            self.multi_fallbacks["mixed_mirostat"] += 1
            return events + self.step()
        cfg, values = agreed
        for i, s in active:  # checked feasible above; cannot raise
            self._ensure_pages(i, min(s.n_past + n_steps,
                                      self.spec.n_ctx) - 1)
        logits, _, _ = self._block_inputs(active)
        lpn = int(g[:, 14].max())
        lpn = None if lpn < 0 else lpn
        ret_state = cfg.mirostat_kind != 0
        out = paged_decode_loop(
            self.spec, self.params, logits, self._frontiers(), self.tables,
            self.pool, n_steps, self._window_pages(gmax2, n_steps), cfg,
            sampler_values=values,
            penalty_state=self._sampler_state(cfg, active, gmax2),
            logprobs_n=lpn, return_state=ret_state,
            uniforms=self._block_noise(cfg, n_steps))
        return events + self._finish_block(active, out, ret_state, lpn,
                                           n_steps)

    def _multi_feasible(self, active, n_steps: int) -> int:
        """The largest (halving) block length whose page demand fits the
        row's pool; hosts with no active streams never constrain the
        least."""
        from llm_tpu_torch.paged import PageAllocator

        if not active:
            return n_steps
        while n_steps > 1:
            need = 0
            for slot, s in active:
                last = min(s.n_past + n_steps, self.spec.n_ctx) - 1
                have = sum(
                    1 for j in range(last // self.page_size + 1)
                    if self.tables[slot, j] != PageAllocator.TRASH)
                need += last // self.page_size + 1 - have
            if need <= self.allocator.available:
                return n_steps
            n_steps //= 2
        return 0
