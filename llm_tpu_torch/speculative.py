"""Speculative decoding: a small draft model proposes, the target verifies.

The counterpart of `llm_tpu/speculative.py`:

- the DRAFT model runs k cheap decode steps on the device (`decode_loop`,
  `decode_loop_batched`),
- the TARGET model scores all k proposals in ONE T=k forward,
- the longest agreeing prefix is accepted plus one bonus token from the
  target's own distribution, and neither cache rewinds: entries at and
  beyond n_past are masked, so rejected positions are overwritten by the
  next round.

Two modes, as the reference's:
- `SpeculativeSession` / `SpeculativeEngine` (greedy): acceptance compares
  argmax, so the output is the target's greedy generation for any draft
  (exactly on the f32 CPU path; on the card the T=k verify reduces its
  bf16 products in another order than a T=1 step, so logits within
  rounding of a tie can flip the argmax).
- `SampledSpeculativeSession` / `SampledSpeculativeEngine`: proposals are
  accepted with probability min(1, p/q) and rejections resample from
  normalize(max(p - q, 0)), in float64 on the host, with numpy
  `Generator`s drawn in the reference's order.

On the card the verify and the T=1 evaluations of bonus and tail tokens
run as captured CUDA graphs (`forward.forward_replay`), as do the draft's
loops; the CPU runs everything eagerly. The paged engines' verify (a T>1
pass over the page pool) and tail evaluation run eagerly.

Under a `mesh` the engines shard the draft exactly as the target
(`parallel/sharding.shard_params`), its dense cache holds the rank's
`data` block of the slots, and their graphs run eagerly. Not
ported yet: snapshots of speculative engines.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from llm_tpu_torch.models.forward import (
    _block_uniforms,
    _graph_ok,
    _on_card,
    _run_block,
    batched_graph,
    batched_step,
    decode_loop,
    decode_loop_batched,
    forward_batched,
    forward_replay,
    forward_step,
    init_cache,
    init_cache_batched,
    load_batched,
    local_spec,
    window_bucket,
)
from llm_tpu_torch.ops.sampling import DeviceSampler, batched_sampler
from llm_tpu_torch.paged import PagedEngine, paged_forward_batched
from llm_tpu_torch.samplers import GreedySampler
from llm_tpu_torch.serve import Engine, _prefill_slot
from llm_tpu_torch.session import ContextFull


def _check_pair(target, draft) -> None:
    if target.spec.n_vocab != draft.spec.n_vocab:
        raise ValueError("draft and target must share a vocabulary")
    if target.device != draft.device:
        raise ValueError(f"draft on {draft.device}, target on "
                         f"{target.device}: load both on one device")


class SpeculativeSession:
    """Greedy speculative decoding over a (target, draft) model pair on
    the target's device. Both models must share a vocabulary."""

    def __init__(self, target, draft, k: int = 4, kv_dtype=torch.bfloat16,
                 n_batch: int = 512):
        _check_pair(target, draft)
        self.target = target
        self.draft = draft
        self.k = k
        self.n_batch = n_batch
        self.device = target.device
        self.t_cache = init_cache(target.spec, kv_dtype, self.device)
        self.d_cache = init_cache(draft.spec, kv_dtype, self.device)
        self.n_past = 0
        self.tokens: list[int] = []
        self.last_logits: Optional[np.ndarray] = None  # target's, at head
        self._draft_logits: Optional[np.ndarray] = None
        self.accepted = 0  # drafted tokens accepted (telemetry)
        self.drafted = 0

    def _window(self, extra: int) -> int:
        return window_bucket(self.n_past + extra, self.target.spec.n_ctx)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def feed_prompt(self, tokens) -> None:
        """Feed the prompt in n_batch chunks, each padded to n_batch (one
        token: 1), except near the context boundary, where the chunk keeps
        its own length so that its rows cannot clobber live entries."""
        toks = [int(t) for t in tokens]
        spec_t, spec_d = self.target.spec, self.draft.spec
        ctx = min(spec_t.n_ctx, spec_d.n_ctx)
        if self.n_past + len(toks) >= ctx:
            raise ContextFull()
        for start in range(0, len(toks), self.n_batch):
            chunk = toks[start : start + self.n_batch]
            n = len(chunk)
            bucket = 1 if n == 1 else self.n_batch
            if self.n_past + bucket > ctx:
                bucket = n
            ids = np.zeros(bucket, np.int64)
            ids[:n] = chunk
            ids = self._ids(ids)
            tl, _, _ = forward_step(
                spec_t, self.target.params, ids, self.n_past, self.t_cache,
                window_bucket(self.n_past, spec_t.n_ctx))
            dl, _, _ = forward_step(
                spec_d, self.draft.params, ids, self.n_past, self.d_cache,
                window_bucket(self.n_past, spec_d.n_ctx))
            self.n_past += n
            self.tokens.extend(chunk)
            self.last_logits = tl[n - 1].cpu().numpy()
            self._draft_logits = dl[n - 1].cpu().numpy()

    def _eval_bonus(self, tok: int, w: int) -> tuple[np.ndarray, np.ndarray]:
        """Evaluate an emitted, never-evaluated token at n_past in both
        models (T=1); returns (target logits, draft logits) [V]."""
        ids = self._ids([[tok]])
        tl = forward_replay(self.target.spec, self.target.params, ids,
                            [self.n_past], self.t_cache, w)
        dl = forward_replay(self.draft.spec, self.draft.params, ids,
                            [self.n_past], self.d_cache, w)
        return tl[0, 0].cpu().numpy(), dl[0, 0].cpu().numpy()

    def _verify(self, proposals, w: int) -> np.ndarray:
        """The target's T=k forward over the proposals: logits [k, V]."""
        return forward_replay(
            self.target.spec, self.target.params,
            torch.as_tensor(proposals, device=self.device)[None],
            [self.n_past], self.t_cache, w)[0].cpu().numpy()

    def generate(
        self,
        max_tokens: int,
        callback: Optional[Callable[[int], None]] = None,
    ) -> list[int]:
        """Greedy-generate up to max_tokens (stops at the target's EoT).
        Returns the generated token ids: plain greedy decoding of the
        target (exactly, up to argmax ties; see the module docstring)."""
        spec_t, spec_d = self.target.spec, self.draft.spec
        eot = self.target.eot_token_id()
        out: list[int] = []

        while len(out) < max_tokens:
            k = min(self.k, max_tokens - len(out),
                    spec_t.n_ctx - 1 - self.n_past)
            if k <= 0:
                break
            w = self._window(k + 1)
            # 1. draft proposes k tokens (chained from the TARGET's current
            # logits, so proposal 0 is the draft's guess at the target's
            # next token); they stay on the device for the verify
            toks, _, _, _ = decode_loop(
                spec_d, self.draft.params, self.last_logits, self.n_past,
                self.d_cache, k, w, DeviceSampler.greedy())

            # 2. target scores all k proposals in one T=k forward
            t_logits = self._verify(toks, w)  # [k, V]
            proposals = toks.cpu().numpy()

            # 3. accept the longest prefix where the target agrees: its
            # prediction for position i is the argmax of the logits BEFORE
            # proposal i (last_logits for i=0, t_logits[i-1] after)
            prev = self.last_logits
            n_acc = 0
            for i in range(k):
                want = int(np.argmax(prev))
                if int(proposals[i]) != want:
                    break
                n_acc += 1
                prev = t_logits[i]
                if want == eot:
                    break
            self.drafted += k
            self.accepted += n_acc

            # 4. emit accepted tokens + one bonus/correction token from the
            # target's own logits at the divergence point
            emitted = [int(p) for p in proposals[:n_acc]]
            hit_eot = bool(emitted and emitted[-1] == eot)
            if not hit_eot and len(out) + n_acc < max_tokens:
                bonus = int(np.argmax(prev))
                emitted.append(bonus)
                hit_eot = bonus == eot
            if not emitted:
                break

            # 5. advance both caches: positions at and beyond n_past stay
            # masked, but the bonus token was never evaluated: evaluate it
            # so that last_logits reflects the whole emitted sequence
            n_keep = len(emitted)
            self.n_past += n_acc
            self.tokens.extend(emitted)
            out.extend(emitted)
            if callback:
                for t in emitted:
                    callback(t)
            if hit_eot:
                break
            if n_keep > n_acc:
                self.last_logits, _ = self._eval_bonus(emitted[-1], w)
                self.n_past += 1
            else:
                # all k accepted, no bonus (budget): the target's logits at
                # the last accepted position are the new head
                self.last_logits = prev
        return out

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


# ---------------------------------------------------------------------------
# sampled speculative decoding (rejection sampling; Leviathan et al. 2022)


def _softmax64(x: np.ndarray) -> np.ndarray:
    z = x - x[np.isfinite(x)].max()
    p = np.exp(z)
    return p / p.sum()


def _sampling_probs(logits: np.ndarray, temperature: float, top_k: int,
                    top_p: float = 1.0, min_p: float = 0.0, bias=()):
    """The device sampler's 'sample' transform as float64 probabilities
    (the acceptance identity needs q to be the distribution the proposals
    were drawn from): flat bias, then truncations on the raw logits (top-k,
    then top-p on the truncated softmax with boundary ties kept, then
    min-p), then temperature."""
    x = logits.astype(np.float64).copy()
    for tid, b in bias:
        x[tid] += b
    if top_k and top_k < x.shape[-1]:
        kth = np.partition(x, -top_k)[-top_k]
        x = np.where(x < kth, -np.inf, x)
    if top_p < 1.0:
        probs = _softmax64(x)
        order = np.argsort(probs)[::-1]
        csum = np.cumsum(probs[order])
        cutoff = probs[order[int(np.searchsorted(csum, top_p))
                            if csum[-1] > top_p else len(order) - 1]]
        x = np.where(probs >= cutoff, x, -np.inf)
    if min_p > 0.0:
        probs = _softmax64(x)
        x = np.where(probs >= min_p * probs.max(), x, -np.inf)
    x = x / max(temperature, 1e-6)
    x = x - x[np.isfinite(x)].max()
    p = np.exp(x)
    return p / p.sum()


def _accept_or_resample(rng, p, q, x: int) -> Optional[int]:
    """The rejection step of one proposal x ~ q: None when it is accepted
    (probability min(1, p(x)/q(x))), else the token resampled from
    normalize(max(p - q, 0)) (from p when that is empty)."""
    if rng.random() < min(1.0, p[x] / max(q[x], 1e-30)):
        return None
    resid = np.maximum(p - q, 0.0)
    tot = resid.sum()
    return (int(rng.choice(len(p), p=resid / tot)) if tot > 0
            else int(rng.choice(len(p), p=p)))


class SampledSpeculativeSession(SpeculativeSession):
    """Speculative decoding with SAMPLED generation: proposals x_i ~ q_i
    from the draft are accepted with probability min(1, p_i(x_i)/q_i(x_i))
    and rejections resample from normalize(max(p_i - q_i, 0)), so the
    output distribution is the target's sampling distribution for any
    draft. Given the seed, the tokens are the reference's."""

    def __init__(self, target, draft, k: int = 4, temperature: float = 0.8,
                 top_k: int = 0, kv_dtype=torch.bfloat16):
        super().__init__(target, draft, k=k, kv_dtype=kv_dtype)
        self.temperature = temperature
        self.top_k = top_k

    def _draft_propose(self, k: int, w: int, rng: np.random.Generator):
        """k draft samples drawn on the host + the pre-sample draft logits
        of each step (a host loop over the draft's T=1 forward)."""
        spec_d = self.draft.spec
        proposals = np.zeros(k, np.int32)
        q_logits = np.zeros((k, spec_d.n_vocab), np.float32)
        logits = self._draft_logits
        for i in range(k):
            q_logits[i] = logits
            q = _sampling_probs(logits, self.temperature, self.top_k)
            proposals[i] = rng.choice(len(q), p=q)
            logits = forward_replay(
                spec_d, self.draft.params, self._ids([[proposals[i]]]),
                [self.n_past + i], self.d_cache, w)[0, 0].cpu().numpy()
        return proposals, q_logits, logits

    def generate(
        self,
        max_tokens: int,
        seed: int = 0,
        callback: Optional[Callable[[int], None]] = None,
    ) -> list[int]:
        rng = np.random.default_rng(seed)
        spec_t = self.target.spec
        eot = self.target.eot_token_id()
        out: list[int] = []

        while len(out) < max_tokens:
            k = min(self.k, max_tokens - len(out),
                    spec_t.n_ctx - 1 - self.n_past)
            if k <= 0:
                break
            w = self._window(k + 1)
            proposals, q_logits, d_head = self._draft_propose(k, w, rng)
            t_logits = self._verify(proposals, w)

            target_heads = [self.last_logits] + [t_logits[i] for i in range(k)]
            emitted: list[int] = []
            n_acc = 0
            corrected = False
            for i in range(k):
                p = _sampling_probs(target_heads[i], self.temperature,
                                    self.top_k)
                q = _sampling_probs(q_logits[i], self.temperature, self.top_k)
                x = int(proposals[i])
                self.drafted += 1
                tok = _accept_or_resample(rng, p, q, x)
                if tok is None:
                    emitted.append(x)
                    n_acc += 1
                    self.accepted += 1
                    if x == eot:
                        break
                else:
                    emitted.append(tok)
                    corrected = True
                    break
            hit_eot = bool(emitted and emitted[-1] == eot)
            if (not corrected and not hit_eot
                    and len(out) + len(emitted) < max_tokens):
                p = _sampling_probs(target_heads[n_acc], self.temperature,
                                    self.top_k)
                bonus = int(rng.choice(len(p), p=p))
                emitted.append(bonus)
                corrected = True  # the bonus also needs evaluation
                hit_eot = bonus == eot
            if not emitted:
                break

            self.n_past += n_acc
            self.tokens.extend(emitted)
            out.extend(emitted)
            if callback:
                for t in emitted:
                    callback(t)
            if hit_eot:
                break
            if corrected:  # the last emitted token was never evaluated
                self.last_logits, self._draft_logits = self._eval_bonus(
                    emitted[-1], w)
                self.n_past += 1
            else:
                self.last_logits = target_heads[n_acc]
                self._draft_logits = d_head
        return out


# ---------------------------------------------------------------------------
# speculative decoding under continuous batching


def _tail_eval(spec, params, ids, n_past, cache, window, write_mask):
    """Masked batched T=1 forward of ids [B]: evaluates correction/bonus
    tokens emitted from host-side resampling without a forward pass.
    Logits [B, V] on the device (a graph replay on the card)."""
    return forward_replay(spec, params, np.asarray(ids)[:, None], n_past,
                          cache, window, write_mask)[:, 0]


class SpeculativeEngine(Engine):
    """Continuous batching with speculative decoding (greedy streams).

    Each engine step runs ONE batched draft block that proposes k tokens
    for every decode-ready stream (`decode_loop_batched` over the draft's
    own dense [L, B] cache), then ONE batched T=k target forward that
    verifies all streams' proposals, then per-stream host acceptance of
    the longest agreeing prefix. Proposal 0 is the argmax of the target's
    own head logits, so a round gives every stream at least one token.

    Greedy only: a request's sampler must be None (forced greedy) or a
    GreedySampler; the output equals the plain Engine's greedy generation
    (exactly on the f32 CPU path; up to argmax ties on the card)."""

    greedy_only = True  # the server routes temperature=0 as sampler=None
    supports_device_logprobs = False  # custom step(): no logprob outputs

    def __init__(self, model, draft, k: int = 4, **kw):
        _check_pair(model, draft)
        if model.spec.n_ctx != draft.spec.n_ctx:
            raise ValueError("batched speculative decoding needs equal "
                             "context windows")
        self.draft = draft
        self.k = k
        super().__init__(model, **kw)
        # the small draft keeps a DENSE cache; an int4 target pool pairs
        # it with int8 (int4 is a paged-pool-only format)
        d_kv = kw.get("kv_dtype", torch.bfloat16)
        self.d_params = draft.params
        if self.mesh is not None:
            # the draft shards exactly like the target
            from llm_tpu_torch.parallel.sharding import shard_params

            self.d_params = shard_params(draft.params, self.mesh, draft.spec)
        self.d_cache = init_cache_batched(
            local_spec(draft.spec, self.d_params), self._local_slots(),
            "int8" if d_kv == "int4" else d_kv, self.device)
        self.accepted = 0
        self.drafted = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    def submit(self, request):
        if request.sampler is None:
            request.sampler = GreedySampler()
        elif not isinstance(request.sampler, GreedySampler):
            raise ValueError("SpeculativeEngine serves greedy streams only")
        return super().submit(request)

    def _draft_prefill_chunk(self, slot: int, toks, pos: int) -> int:
        """One n_batch chunk of DRAFT prefill for a slot; returns the new
        position. Shared by the lockstep prefill and the borrowed-prefix
        replay."""
        spec_d = self.draft.spec
        chunk = toks[pos : pos + self.n_batch]
        bucket = (
            self.n_batch if pos + self.n_batch <= spec_d.n_ctx else len(chunk)
        )
        ids = np.zeros(bucket, np.int64)
        ids[: len(chunk)] = chunk
        _prefill_slot(spec_d, self.d_params,
                      torch.from_numpy(ids).to(self.device), pos, slot,
                      self.d_cache, window_bucket(pos, spec_d.n_ctx),
                      self.max_streams)
        return pos + len(chunk)

    def _prefill_chunk(self, stream, slot):
        # the draft cache prefills in lockstep with the target's
        self._draft_prefill_chunk(slot, stream.prefill_queue,
                                  stream.prefill_pos)
        super()._prefill_chunk(stream, slot)

    def step_multi(self, n_steps: int = 16):
        # a speculative round is already multi-token; block mode would
        # bypass verification
        return self.step()

    def _reserve_round(self, decodable, k: int) -> bool:
        """Reserve room for a k-token verify per stream; dense slot caches
        always have it (the paged engines allocate pages)."""
        return True

    def _verify_batch(self, proposals, n_past, mask, max_past, k,
                      extra: int = 0) -> np.ndarray:
        """One batched T=k target forward over all streams' proposals
        [B, k]; returns [B, k, V] logits on the host. `extra` widens the
        window (the sampled variant shares it with its T=1 tail eval)."""
        window = window_bucket(max_past + k + extra, self.spec.n_ctx)
        return forward_replay(self.spec, self.params, proposals, n_past,
                              self.cache, window, mask).cpu().numpy()

    def _fallback_step(self):
        """Per-token progress when a speculative round cannot run (the
        context boundary, a page pool too tight for the round, an argmax
        tie)."""
        events = super().step()
        self._draft_catchup()
        return events

    def _draft_catchup(self):
        """A fallback step advanced streams through the TARGET only; the
        emitted token must also be evaluated into the dense DRAFT cache,
        or the next round's proposals would condition on the stale row the
        last draft block wrote there (its rejected proposal). Evaluating
        an already consistent row writes the same KV."""
        B = self.max_streams
        ids = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        for slot, s in enumerate(self.slots):
            if (s is not None and not s.prefilling and s.tokens
                    and s.n_past > 0):
                ids[slot] = s.tokens[-1]
                pos[slot] = s.n_past - 1
                mask[slot] = True
        if not mask.any():
            return
        window = window_bucket(int(pos.max()) + 1, self.draft.spec.n_ctx)
        _tail_eval(self.draft.spec, self.d_params, ids, pos, self.d_cache,
                   window, mask)

    def _round_inputs(self, decodable):
        """(head logits [B, V], n_past [B], write mask [B], max n_past) of
        the decode-ready streams; empty slots stay zero and masked."""
        B = self.max_streams
        ll = np.zeros((B, self.spec.n_vocab), np.float32)
        n_past = np.zeros(B, np.int32)
        mask = np.zeros(B, bool)
        for slot, s in decodable:
            ll[slot] = s.last_logits
            n_past[slot] = s.n_past
            mask[slot] = True
        return ll, n_past, mask, int(n_past.max())

    def step(self):
        self._admit()
        self._advance_prefills()
        events = self._drain_retired()
        decodable = self._decodable()
        if not decodable:
            return events

        spec = self.spec
        ll, n_past, mask, max_past = self._round_inputs(decodable)
        k = min(self.k, spec.n_ctx - 1 - max_past)
        if k <= 0 or not self._reserve_round(decodable, k):
            # at the context boundary (or a page pool too tight for the
            # round) the plain path makes progress or retires cleanly
            return events + self._fallback_step()
        window = window_bucket(max_past + k, spec.n_ctx)

        # 1. the draft proposes k tokens per stream (proposal 0 chains from
        # the TARGET's head logits, so it is that stream's own argmax)
        toks, _, _, _ = decode_loop_batched(
            self.draft.spec, self.d_params, ll, n_past, self.d_cache, k,
            window, write_mask=torch.from_numpy(mask).to(self.device))

        # 2. the target verifies all proposals in one batched T=k forward
        t_logits = self._verify_batch(toks.T, n_past, mask, max_past, k)
        proposals = toks.T.cpu().numpy()  # [B, k]

        # 3. per-stream host acceptance of the longest agreeing prefix
        eot = self._eot
        accepted = {}
        for slot, stream in decodable:
            prev = np.asarray(stream.last_logits)
            n_acc = 0
            for i in range(k):
                want = int(np.argmax(prev))
                if int(proposals[slot, i]) != want:
                    break
                n_acc += 1
                prev = t_logits[slot, i]
                if want == eot:
                    break
            self.drafted += k
            self.accepted += n_acc
            accepted[slot] = n_acc
        if min(accepted.values()) == 0:
            # an argmax tie flipped by the card's reduction order: one
            # plain step makes progress instead
            return events + self._fallback_step()

        for slot, stream in decodable:
            for i in range(accepted[slot]):
                if stream.done:
                    break
                events.append(self._finish_token(
                    slot, stream, int(proposals[slot, i]),
                    t_logits[slot, i],
                ))
        return events


@torch.no_grad()
def _draft_propose_batched(spec, params, last_logits, n_past, cache, k: int,
                           uniforms, window: int, sampler, sampler_values,
                           write_mask):
    """The batched draft loop that ALSO returns each step's pre-sample
    draft logits: (tokens [k, B] int32, q logits [k, B, V] f32), on the
    device. Step i samples from the logits before it (step 0: the target's
    head logits `last_logits` [B, V]) with the uniforms [k, B, V] of that
    step, then evaluates the tokens at T=1. On the card a CUDA graph
    captured once per static key (`cache.graphs`) is replayed once a step,
    as `decode_loop_batched`'s."""
    dev = cache.k.device
    B, S = last_logits.shape[0], cache.k.shape[3]
    W = min(window, S)
    u = _block_uniforms(sampler, uniforms, None, (k, B, spec.n_vocab), dev)
    mask = torch.as_tensor(write_mask, dtype=torch.bool)
    on_card = _on_card(_graph_ok(True, params, dev), dev)

    def extra(st):
        st["mask"] = torch.zeros(B, dtype=torch.bool, device=dev)
        st["q"] = torch.zeros((st["toks"].shape[0], B, spec.n_vocab),
                              dtype=torch.float32, device=dev)

    g = batched_graph(cache.graphs, ("draft_q", W), spec, params, B, sampler,
                      sampler_values, None, False, None, k, dev, on_card,
                      extra)
    st = g.state

    def forward(tok, i):
        # the logits the step sampled from are still in the buffer
        st["q"].index_copy_(0, i, st["logits"][None])
        return forward_batched(spec, params, tok[:, None], st["npast"],
                               cache, W, st["mask"])[0][:, 0]

    def load(st):
        load_batched(st, last_logits, n_past, None, sampler_values, u)
        st["mask"].copy_(mask)

    _run_block(g, lambda: batched_step(st, sampler, g.bias, forward), load,
               k, on_card, dev)
    return st["toks"][:k].clone(), st["q"][:k].clone()


class SampledSpeculativeEngine(SpeculativeEngine):
    """Rejection-sampling speculative decoding under continuous batching.

    Each request carries a DeviceSampler(kind="sample", temperature,
    top_k, ...); the draft SAMPLES its proposals on the device under each
    stream's own parameters (`batched_sampler`), with a round's uniforms
    [k, B, V] drawn from the engine's generator (`_block_uniforms`); the
    target verifies in one batched T=k forward; acceptance follows the
    exact identity on the host with each stream's numpy rng (its
    request.seed). Correction and bonus tokens are emitted at once and
    evaluated by ONE masked batched T=1 forward pair before the next
    round."""

    greedy_only = False
    requires_device_sampler = True  # the server always builds one

    def submit(self, request):
        ds = request.device_sampler
        if ds is not None and getattr(ds, "kind", None) == "greedy":
            # greedy is the degenerate sample: top-k 1 makes the sampling
            # distribution a point mass at the argmax, so acceptance
            # reduces exactly to the greedy engine's comparison
            ds = dataclasses.replace(ds, kind="sample", temperature=1.0,
                                     top_k=1, top_p=1.0, min_p=0.0)
            request.device_sampler = ds
        if ds is None or getattr(ds, "kind", None) != "sample":
            raise ValueError(
                "SampledSpeculativeEngine requests need a "
                'DeviceSampler(kind="sample", ...) as device_sampler'
            )
        if getattr(ds, "has_penalties", False):
            # acceptance compares DRAFT vs TARGET distributions; windowed
            # penalties would have to be applied identically to both per
            # position, which the one-shot T=k verify cannot do
            raise ValueError(
                "speculative serving does not support repetition/"
                "frequency/presence penalties; use the non-speculative "
                "engine for penalized requests"
            )
        if getattr(ds, "mirostat", 0):
            # min(1, p/q) needs a FIXED per-position proposal distribution;
            # mirostat's mu feedback changes it per sampled token
            raise ValueError(
                "speculative serving does not support mirostat; use the "
                "non-speculative engine for mirostat requests"
            )
        if (getattr(ds, "tail_free_z", 1.0) < 1.0
                or getattr(ds, "typical_p", 1.0) < 1.0
                or getattr(ds, "top_a", (0.0, 0.0)) != (0.0, 0.0)):
            # the acceptance math (_sampling_probs) rebuilds q from
            # temperature/top-k/top-p/min-p/bias only; a proposal drawn
            # under other truncations would not match the q it is scored
            # against
            raise ValueError(
                "speculative serving does not support tail-free/"
                "locally-typical/top-a truncations; use the "
                "non-speculative engine for those requests"
            )
        # bypass SpeculativeEngine's greedy guard; Engine.submit defaults
        # the (unused) host sampler chain
        return Engine.submit(self, request)

    def step(self):
        self._admit()
        self._advance_prefills()
        events = self._drain_retired()
        decodable = self._decodable()
        if not decodable:
            return events

        spec = self.spec
        B = self.max_streams
        ll, n_past, mask, max_past = self._round_inputs(decodable)
        # one below the greedy clamp: a bonus token may extend past k
        k = min(self.k, spec.n_ctx - 2 - max_past)
        if k <= 0 or not self._reserve_round(decodable, k + 1):
            return events + self._fallback_step()
        window = window_bucket(max_past + k + 1, spec.n_ctx)

        per_slot = [None] * B
        for slot, s in decodable:
            per_slot[slot] = s.request.device_sampler
        sampler, values = batched_sampler(per_slot, B, self.device)

        toks, q_logits = _draft_propose_batched(
            self.draft.spec, self.d_params, ll, n_past, self.d_cache, k,
            self._block_uniforms(k, True), window, sampler, values,
            torch.from_numpy(mask).to(self.device))
        t_logits = self._verify_batch(
            toks.T, n_past, mask, max_past, k, extra=1)  # [B, k, V]
        proposals = toks.T.cpu().numpy()  # [B, k]
        q_logits = q_logits.cpu().numpy()  # [k, B, V]

        eot = self._eot
        tail_ids = np.zeros(B, np.int64)
        tail_mask = np.zeros(B, bool)
        tail_streams = []
        for slot, stream in decodable:
            ds = stream.request.device_sampler
            tr = dict(temperature=ds.temperature, top_k=ds.top_k,
                      top_p=ds.top_p, min_p=ds.min_p, bias=ds.bias)
            rng = stream.rng
            heads = [np.asarray(stream.last_logits)] + [
                t_logits[slot, i] for i in range(k)
            ]
            n_acc = 0
            tail = None  # correction/bonus token, unevaluated
            for i in range(k):
                p = _sampling_probs(heads[i], **tr)
                q = _sampling_probs(q_logits[i, slot], **tr)
                x = int(proposals[slot, i])
                self.drafted += 1
                tail = _accept_or_resample(rng, p, q, x)
                if tail is not None:
                    break
                n_acc += 1
                self.accepted += 1
                if x == eot:
                    break
            accepted_eot = n_acc and int(proposals[slot, n_acc - 1]) == eot
            if tail is None and not accepted_eot:
                # bonus token from the target head at the frontier
                p = _sampling_probs(heads[n_acc], **tr)
                tail = int(rng.choice(len(p), p=p))

            for i in range(n_acc):
                if stream.done:
                    break
                events.append(self._finish_token(
                    slot, stream, int(proposals[slot, i]), t_logits[slot, i]
                ))
            if tail is not None and not stream.done:
                # emit now; its post-logits come from the tail eval below
                events.append(self._finish_token(
                    slot, stream, tail, heads[n_acc]
                ))
                if not stream.done:
                    tail_ids[slot] = tail
                    tail_mask[slot] = True
                    tail_streams.append((slot, stream))

        if tail_mask.any():
            pos = np.zeros(B, np.int32)
            for slot, stream in tail_streams:
                pos[slot] = stream.n_past - 1  # the tail token's position
            tl = self._tail_eval_target(tail_ids, pos, tail_mask, window)
            _tail_eval(self.draft.spec, self.d_params, tail_ids, pos,
                       self.d_cache, window, tail_mask)
            tl = tl.cpu().numpy()
            for slot, stream in tail_streams:
                stream.last_logits = tl[slot]
        return events

    def _tail_eval_target(self, tail_ids, pos, tail_mask, window):
        """Masked T=1 target eval of the emitted correction/bonus tokens:
        logits [B, V] on the device (dense cache here; paged override)."""
        return _tail_eval(self.spec, self.params, tail_ids, pos, self.cache,
                          window, tail_mask)


class _PagedSpeculativeMixin:
    """Paged-target plumbing shared by the greedy and sampled paged
    speculative engines: page reservation per round, the T=k verify and
    T=1 tail eval through the paged forward (eager), and the per-token
    paged fallback. Verify overshoot is safe as in the dense engines:
    unaccepted positions stay masked and lie in the stream's OWN pages (a
    borrowed prefix ends at the prompt boundary, below every verify
    position), so shared pages are never written."""

    def _reserve_round(self, decodable, k: int) -> bool:
        try:
            for slot, s in decodable:
                self._ensure_pages(
                    slot, min(s.n_past + k, self.spec.n_ctx) - 1
                )
        except MemoryError:
            return False
        return True

    def _fallback_step(self):
        events = PagedEngine.step(self)
        self._draft_catchup()  # dense draft cache: the dense engines' repair
        return events

    def _begin_prefill(self, stream, slot: int) -> None:
        super()._begin_prefill(stream, slot)
        # a borrowed prompt-prefix page chain (prefix_cache) skips TARGET
        # prefill for those positions, but the dense DRAFT cache has no
        # such reuse: prefill the draft over the skipped region now, or
        # its attention would read a previous occupant's stale KV there
        pos = 0
        while pos < stream.prefill_pos:
            pos = self._draft_prefill_chunk(slot, stream.prefill_queue, pos)

    def _adjusted_n_past(self, n_past):
        """Dummy rows have no write mask in the paged forward: park a
        prefilling slot's writes at its frontier (the next real chunk
        overwrites them); empty slots' rows go to the trash page."""
        n_past = np.array(n_past)
        for slot, s in enumerate(self.slots):
            if s is not None and s.prefilling:
                n_past[slot] = s.prefill_pos
        return n_past

    def _paged_forward(self, ids, n_past, wp: int) -> torch.Tensor:
        """The target's paged forward of ids [B, T] at n_past [B] over the
        tables as they are now (copied at dispatch): logits [B, T, V]."""
        dev = self.device
        logits, _, _ = paged_forward_batched(
            self.spec, self.params, torch.as_tensor(ids, device=dev),
            torch.tensor(n_past, dtype=torch.int32, device=dev),
            torch.tensor(self.tables, device=dev), self.pool, wp)
        return logits

    def _verify_batch(self, proposals, n_past, mask, max_past, k,
                      extra: int = 0) -> np.ndarray:
        wp = min(
            -(-(max_past + k + extra) // self.page_size),
            self.pages_per_stream,
        )
        return self._paged_forward(proposals, self._adjusted_n_past(n_past),
                                   wp).cpu().numpy()

    def _tail_eval_target(self, tail_ids, pos, tail_mask, window):
        # rows outside tail_mask: every surviving decodable stream IS a
        # tail stream (the others retired), so the only dummy rows are
        # prefilling (frontier-parked) or empty (trash page) slots
        pos = self._adjusted_n_past(pos)
        wp = min(
            max(1, -(-(int(pos.max()) + 1) // self.page_size)),
            self.pages_per_stream,
        )
        return self._paged_forward(np.asarray(tail_ids)[:, None], pos,
                                   wp)[:, 0]


class PagedSpeculativeEngine(
    _PagedSpeculativeMixin, SpeculativeEngine, PagedEngine
):
    """Speculative decoding over a PAGED target KV pool (greedy streams).

    The target's KV rides PagedEngine's shared page pool (bf16/f32/int8/
    int4, optional prompt-prefix cache), while the small draft keeps a
    dense [L, B] cache. Each round allocates pages for the k verify
    positions; a pool too tight for the round falls back to the plain
    paged per-token step (and its kv_oom retirement rules).

    MRO: the mixin supplies the paged verify/reserve/fallback,
    SpeculativeEngine the round logic, PagedEngine the device state (pool,
    tables, allocator, paged prefill)."""


class PagedSampledSpeculativeEngine(
    _PagedSpeculativeMixin, SampledSpeculativeEngine, PagedEngine
):
    """Rejection-sampling speculative decoding over a PAGED target pool:
    the round reserves k+1 positions (the correction/bonus tail extends
    one past the proposals) and its T=1 tail eval runs through the paged
    forward."""
