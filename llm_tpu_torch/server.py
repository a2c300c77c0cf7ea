"""HTTP serving front-end over the continuous-batching engine.

The counterpart of `llm_tpu/server.py`: an OpenAI-style REST API on the
stdlib `http.server`, so it adds no dependencies.

  POST /v1/completions   {"prompt", "max_tokens", "temperature", "top_k",
                          "top_p", "seed", "stop", "stream", "n",
                          "logprobs", "logit_bias", ...}
                         non-stream -> one JSON body; "stream": true ->
                         server-sent events, one data: line per UTF-8
                         fragment, closing with data: [DONE]
  POST /v1/chat/completions  {"messages", "chat_template", ...}: the
                         messages rendered to a prompt (`render_chat`),
                         the user prefix joining the stop set; answers as
                         chat.completion / chat.completion.chunk
  POST /v1/embeddings    {"input"}: the final token's hidden state of each
                         input, from a dedicated session on the engine
                         thread
  POST /admin/checkpoint {"path"}: an engine checkpoint between steps
                         (`engine_snapshot.write_engine`); 200, or 409
                         with the reason. A path must lie in the
                         directory of the server's `engine_snapshot`
  GET  /v1/models        model listing
  GET  /health           liveness + engine occupancy
  GET  /metrics          request/token counters and TTFT percentiles

Threading model: ONE background thread owns the Engine — submissions,
cancellations and `step()` (or, with `multi_step` N > 1, `step_multi(N)`
whenever every slot decodes with a device sampler) all happen there (the
Engine is single-threaded by contract). HTTP handler threads (ThreadingHTTPServer) talk to it through
queues: a submission carries its own reply queue, and every engine event
for that request id is forwarded to it. Client disconnects cancel the
stream so its slot (and pages, for a paged engine) free at once.

Stop sequences are scanned server-side with a holdback buffer: text that
could still be a prefix of a stop string is withheld until disambiguated,
so a stop string split across token fragments never leaks to the client.

With `multi_step` N > 1, a request whose sampling the device can express
(`device_sampler_from_params`: greedy or temperature with top-k, top-p,
min-p, tail-free, typical, mirostat, penalties and logit bias) carries a
DeviceSampler, and the engine decodes blocks of N tokens on the device
while no prompt is pending or prefilling.

With a draft model (`build_engine`'s `draft`) the engine is one of the
four speculative engines (`speculative.py`). A greedy-only one serves
temperature 0 with its own greedy sampler; a sampled one needs a device
sampler on every request, so an omitted temperature means 1.0 there.

With `engine_snapshot` the server restores the engine from that file at
construction when it exists (its streams finish headless), writes it on a
graceful shutdown, and serves /admin/checkpoint. A file the restore
refuses is moved to `<path>.corrupt` and the server starts fresh.

With a multi-host engine (`parallel/multihost.py`; `serve_forever`'s
`multihost`) each process runs one rank of a world. The leader of each
`model` row (a host) binds its own HTTP endpoint and serves its own
streams; the other ranks of the row bind none and run the leader's
requests. `_MultiHostEngineLoop` keeps every rank's engine calls in
lockstep: each tick the leader broadcasts its inbox's operations to its
row, then the world all-gathers [has_work, stop] and every rank takes the
same branch (step, idle, or exit once every row has asked to stop and no
work is left). Each rank's checkpoint is its own file, `<path>.host<N>`
(N its rank) when the world has more than one rank; at construction the
world restores every rank's file or, when one is refused or missing,
sets them all aside and starts fresh.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from llm_tpu_torch.ops.sampling import DeviceSampler
from llm_tpu_torch.samplers import (
    SamplerConfigurationError,
    build_sampler_chain,
    default_samplers,
)
from llm_tpu_torch.serve import Engine, GenerationRequest

__all__ = ["LlmServer", "device_sampler_from_params", "sampler_from_params",
           "serve_forever"]


def _logit_bias(params: dict) -> tuple:
    """OpenAI `logit_bias` {token_id: additive bias}; -100 bans a token
    outright (the API's documented semantics), mapped to -inf."""
    raw = params.get("logit_bias") or {}
    return tuple(
        (int(k), float("-inf") if float(v) <= -100.0 else float(v))
        for k, v in raw.items()
    )


def sampler_from_params(params: dict, n_vocab: int = 0):
    """Map OpenAI-style sampling params onto the sampler-chain DSL.

    temperature=0 means greedy (top-k 1). Unknown keys are ignored (the
    API surface is a superset across clients); explicit `sampler` strings
    pass straight through to the DSL."""
    bias = _logit_bias(params)
    if params.get("sampler"):
        raw = params["sampler"]
        args = raw if isinstance(raw, list) else [raw]
        return build_sampler_chain(args, n_vocab=n_vocab, bias=bias)
    args = []
    temp = params.get("temperature")
    if temp is not None and float(temp) <= 0.0:
        return build_sampler_chain(["topk:k=1", "temperature:1.0"],
                                   n_vocab=n_vocab, bias=bias)
    if params.get("repeat_penalty") is not None:
        args.append(f"repetition:penalty={float(params['repeat_penalty'])}")
    if params.get("frequency_penalty") is not None or \
            params.get("presence_penalty") is not None:
        fp = float(params.get("frequency_penalty") or 0.0)
        pp = float(params.get("presence_penalty") or 0.0)
        args.append(f"freqpresence:frequency={fp}:presence={pp}")
    miro = int(params.get("mirostat") or 0)
    if miro:
        # mirostat excludes the truncation samplers (DSL validation)
        tau = float(params.get("mirostat_tau") or 5.0)
        eta = float(params.get("mirostat_eta") or 0.1)
        args.append(f"mirostat{miro}:tau={tau}:eta={eta}")
    else:
        if params.get("top_k") is not None:
            args.append(f"topk:k={int(params['top_k'])}")
        if params.get("top_p") is not None:
            args.append(f"topp:p={float(params['top_p'])}")
        if params.get("min_p") is not None:
            args.append(f"minp:p={float(params['min_p'])}")
        if params.get("tfs_z") is not None:
            args.append(f"tailfree:z={float(params['tfs_z'])}")
        if params.get("typical_p") is not None:
            args.append(f"locallytypical:p={float(params['typical_p'])}")
    if temp is not None:
        args.append(f"temperature:{float(temp)}")
    if not args and not bias:
        return default_samplers()
    return build_sampler_chain(args, n_vocab=n_vocab, bias=bias)


def device_sampler_from_params(params: dict, allow_logprobs: bool = False,
                               allow_bias: bool = True):
    """A DeviceSampler for a request the device can sample (greedy or
    temperature, with top-k, top-p, min-p, tail-free, typical or mirostat,
    windowed repetition / frequency / presence penalties and logit bias),
    so a multi-step server decodes it in blocks. None when the request
    needs the host chain: an explicit sampler DSL, no temperature (the
    full default chain), logprobs unless `allow_logprobs`, a logit bias
    unless `allow_bias` (a multi-host block would need the hosts to agree
    on the biased tokens)."""
    if params.get("sampler") is not None:
        return None
    if params.get("logprobs") is not None and not allow_logprobs:
        return None
    if params.get("logit_bias") and not allow_bias:
        return None
    temp = params.get("temperature")
    if temp is None:
        return None

    def _f(key, default):
        v = params.get(key)  # 0 and 0.0 are values, not "unset"
        return default if v is None else float(v)

    penalties = {
        "repeat_penalty": _f("repeat_penalty", 1.0),
        "frequency_penalty": _f("frequency_penalty", 0.0),
        "presence_penalty": _f("presence_penalty", 0.0),
        "bias": _logit_bias(params),
    }
    if float(temp) <= 0.0:
        return DeviceSampler(kind="greedy", **penalties)
    miro = int(_f("mirostat", 0))
    if miro:
        return DeviceSampler(kind="sample", temperature=float(temp),
                             mirostat=miro,
                             mirostat_tau=_f("mirostat_tau", 5.0),
                             mirostat_eta=_f("mirostat_eta", 0.1),
                             **penalties)
    return DeviceSampler(kind="sample", temperature=float(temp),
                         top_k=int(_f("top_k", 0)),
                         top_p=_f("top_p", 1.0),
                         min_p=_f("min_p", 0.0),
                         tail_free_z=_f("tfs_z", 1.0),
                         typical_p=_f("typical_p", 1.0),
                         **penalties)


DEFAULT_CHAT_TEMPLATE = {
    # the vicuna-chat convention: role prefixes, the user prefix doubling
    # as the stop sequence
    "system": "{content}\n\n",
    "user": "### Human: {content}\n",
    "assistant": "### Assistant: {content}\n",
    "generation_prefix": "### Assistant: ",
    "stop": "### Human:",
}


def render_chat(messages, template=None, jinja=None) -> tuple[str, str]:
    """[{role, content}] -> (prompt, stop sequence).

    Precedence: a per-request `chat_template` dict (role-format strings),
    then the model's own HF-convention jinja template (GGUF
    `tokenizer.chat_template`, rendered with add_generation_prompt), then
    the built-in vicuna-style default. Unknown roles render with the user
    prefix. Every template failure is a ValueError, which the handler
    answers with a 400."""
    if template is None and jinja:
        try:
            import jinja2
        except ImportError:
            raise ValueError(
                "this checkpoint's chat template needs jinja2, which is "
                "not installed; pass a chat_template dict instead"
            )
        compiled = _JINJA_CACHE.get(jinja)
        try:
            if compiled is None:
                env = jinja2.Environment()  # noqa: S701 — text templating
                env.globals["raise_exception"] = _jinja_raise
                compiled = env.from_string(jinja)
                if len(_JINJA_CACHE) > 8:
                    _JINJA_CACHE.clear()
                _JINJA_CACHE[jinja] = compiled
            prompt = compiled.render(
                messages=list(messages),
                add_generation_prompt=True,
                bos_token="",
                eos_token="",
            )
        except jinja2.TemplateError as e:
            raise ValueError(f"chat template error: {e}") from e
        # generation halts at the model's own EoT; no textual stop needed
        return prompt, ""
    t = dict(DEFAULT_CHAT_TEMPLATE)
    if template:
        t.update(template)
    parts = []
    for m in messages:
        fmt = t.get(m.get("role", "user")) or t["user"]
        parts.append(fmt.format(content=m.get("content", "")))
    parts.append(t["generation_prefix"])
    return "".join(parts), t["stop"]


_JINJA_CACHE: dict = {}  # compiled template by source text


def _jinja_raise(message):
    """HF chat templates call raise_exception() for unsupported inputs."""
    raise ValueError(message)


class _StopScanner:
    """Holdback scanner: emit only text that cannot still become a stop
    string; report a match exactly once, with the match excised."""

    def __init__(self, stops):
        self.stops = [s for s in (stops or []) if s]
        self.buf = ""
        self.hit = False

    def push(self, text: str) -> str:
        if not self.stops:
            return text
        self.buf += text
        # the EARLIEST occurrence across all stop strings wins
        best = min(
            (i for i in (self.buf.find(s) for s in self.stops) if i >= 0),
            default=-1,
        )
        if best >= 0:
            out, self.buf = self.buf[:best], ""
            self.hit = True
            return out
        # longest tail that is a proper prefix of some stop string
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        out = self.buf[: len(self.buf) - hold]
        self.buf = self.buf[len(self.buf) - hold :]
        return out

    def flush(self) -> str:
        out, self.buf = self.buf, ""
        return out


@dataclass
class _Ticket:
    request: GenerationRequest
    events: "queue.Queue" = field(default_factory=queue.Queue)
    request_id: Optional[int] = None
    ready: threading.Event = field(default_factory=threading.Event)
    t_submit: float = field(default_factory=time.monotonic)
    t_first: Optional[float] = None  # first token event (TTFT)


class _EngineLoop(threading.Thread):
    """The single thread that owns the Engine. With multi_step N > 1 it runs
    `step_multi(N)` when nothing is pending and every slot is empty or
    decoding with a device sampler, else `step()`."""

    def __init__(self, engine: Engine, multi_step: int = 0,
                 snapshot_path=None):
        super().__init__(daemon=True, name="llm-tpu-torch-engine")
        self.engine = engine
        self.multi_step = multi_step
        self.snapshot_path = snapshot_path  # final checkpoint on shutdown
        self.inbox: "queue.Queue" = queue.Queue()
        self.tickets: dict[int, _Ticket] = {}
        self.stopping = False
        self.stats = {
            "requests_completed": 0,
            "tokens_generated": 0,
            "started_at": time.monotonic(),
        }
        self._ttft_ms: list[float] = []  # last 1024 samples

    def submit(self, ticket: _Ticket) -> int:
        self.inbox.put(("submit", ticket))
        ticket.ready.wait()
        return ticket.request_id

    def cancel(self, request_id: int) -> None:
        self.inbox.put(("cancel", request_id))

    def shutdown(self) -> None:
        self.inbox.put(("stop", None))

    def _drain_inbox(self, block: bool) -> None:
        while True:
            try:
                kind, payload = self.inbox.get(block=block, timeout=0.2)
            except queue.Empty:
                return
            block = False
            if kind == "submit":
                if self.stopping:
                    # a submit racing shutdown must fail fast, not hang
                    # its handler on a loop that will never step again
                    payload.request_id = -1
                    payload.events.put(("", True, "error: server stopping",
                                        None))
                    payload.ready.set()
                    continue
                try:
                    payload.request_id = self.engine.submit(payload.request)
                    self.tickets[payload.request_id] = payload
                except Exception as e:  # noqa: BLE001 — fail THIS request,
                    # not the loop
                    payload.request_id = -1
                    payload.events.put(("", True, f"error: {e}", None))
                payload.ready.set()
            elif kind == "cancel":
                self.engine.cancel(payload)
            elif kind == "embed":
                inputs, out_q = payload
                try:
                    out_q.put(("ok", self._embed(inputs)))
                except Exception as e:  # noqa: BLE001
                    out_q.put(("error", str(e)))
            elif kind == "checkpoint":
                path, out_q = payload
                out_q.put(self._checkpoint(path, client=True))
            elif kind == "stop":
                # keep draining: a checkpoint or submit racing shutdown
                # still gets an answer
                self.stopping = True

    def _checkpoint(self, path, client: bool = False) -> tuple[str, str]:
        """Write an engine checkpoint between steps (this is the engine
        thread, so the engine is quiesced). A `client` path (from HTTP)
        must lie in the configured snapshot's directory: the endpoint is
        no arbitrary-path file write."""
        from llm_tpu_torch.engine_snapshot import write_engine

        if not self.snapshot_path:
            return ("error", "no snapshot path configured")
        if path and client:
            want_dir = os.path.dirname(os.path.abspath(self.snapshot_path))
            if os.path.dirname(os.path.abspath(path)) != want_dir:
                return ("error", "path must live in the configured "
                                 f"snapshot directory {want_dir}")
        path = path or self.snapshot_path
        try:
            self._dispatch(self.engine._drain_retired())
            write_engine(self.engine, path)
            return ("ok", str(path))
        except Exception as e:  # noqa: BLE001 — e.g. a custom sampler
            return ("error", str(e))

    def checkpoint(self, path=None, timeout: float = 600.0):
        """From a handler thread: checkpoint without stopping the server."""
        out_q: "queue.Queue" = queue.Queue()
        self.inbox.put(("checkpoint", (path, out_q)))
        try:
            return out_q.get(timeout=timeout)
        except queue.Empty:
            return ("error", "engine loop did not respond (shutting down?)")

    def _embed(self, inputs) -> list:
        """The final token's hidden state of each input, through a
        dedicated session on the engine thread (the device never sees two
        threads' work interleaved)."""
        from llm_tpu_torch.session import (
            InferenceSession,
            InferenceSessionConfig,
            OutputRequest,
        )

        model = self.engine.model
        out = []
        for text in inputs:
            session = InferenceSession(model, InferenceSessionConfig())
            req = OutputRequest(embeddings=[])
            session.feed_prompt(text, output_request=req)
            emb = np.asarray(req.embeddings, np.float32).reshape(
                -1, model.spec.n_embd)
            out.append([float(x) for x in emb[-1]])
        return out

    def embed(self, inputs, timeout: float = 600.0) -> list:
        out_q: "queue.Queue" = queue.Queue()
        self.inbox.put(("embed", (inputs, out_q)))
        status, result = out_q.get(timeout=timeout)
        if status == "error":
            raise RuntimeError(result)
        return result

    def _dispatch(self, events) -> None:
        for rid, text, done in events:
            ticket = self.tickets.get(rid)
            if ticket is None:
                continue
            if text and ticket.t_first is None:
                ticket.t_first = time.monotonic()
                self._ttft_ms.append((ticket.t_first - ticket.t_submit) * 1e3)
                del self._ttft_ms[:-1024]
            reason, info = "", None
            if done:
                fin = self.engine.finished.get(rid)
                reason = fin.finish_reason if fin else "done"
                if fin is not None and fin.logprob_data:
                    info = {"logprobs": fin.logprob_data}
                self.stats["requests_completed"] += 1
                self.stats["tokens_generated"] += fin.generated if fin else 0
                del self.tickets[rid]
            ticket.events.put((text, done, reason, info))

    def metrics(self) -> dict:
        ttft = sorted(self._ttft_ms)
        pick = (lambda q: round(ttft[min(len(ttft) - 1,
                                         int(q * len(ttft)))], 2)) \
            if ttft else (lambda q: None)
        return {
            **{k: v for k, v in self.stats.items() if k != "started_at"},
            "uptime_s": round(time.monotonic() - self.stats["started_at"], 1),
            "active_streams": self.engine.active,
            "pending": len(self.engine.pending),
            "ttft_ms_p50": pick(0.50),
            "ttft_ms_p95": pick(0.95),
        }

    def _should_exit(self) -> bool:
        return self.stopping

    def _fail_tickets(self, reason: str) -> None:
        tickets, self.tickets = self.tickets, {}
        for t in tickets.values():
            t.events.put(("", True, reason, None))

    def run(self) -> None:
        while not self._should_exit():
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — an engine failure must not
                # strand waiting handlers on a dead thread: fail their
                # requests and keep serving
                traceback.print_exc()
                self._fail_tickets("error: engine step failed")
        if self.snapshot_path:
            status, info = self._checkpoint(self.snapshot_path)
            print(f"engine checkpoint on shutdown: {status} {info}",
                  flush=True)

    def _tick(self) -> None:
        self._drain_inbox(block=not self.engine.has_work())
        # cancellations (and admission failures) retire streams without a
        # step(): flush their done-events now or a waiting handler
        # deadlocks on an idle engine
        self._dispatch(self.engine._drain_retired())
        if self.stopping or not self.engine.has_work():
            return
        if self.multi_step > 1 and not self.engine.pending and all(
            s is None or (not s.prefilling
                          and s.request.device_sampler is not None)
            for s in self.engine.slots
        ):
            self._dispatch(self.engine.step_multi(self.multi_step))
        else:
            self._dispatch(self.engine.step())


class _MultiHostEngineLoop(_EngineLoop):
    """A rank's loop over a MultiHostEngine: serving across hosts, each
    row's leader with its own HTTP endpoint and streams.

    Every engine operation of a MultiHostEngine is collective, so every
    rank must make the same calls in the same order. Each tick:
    1. the row's leader drains its inbox and broadcasts the row's
       operations (submit with its request, cancel, stop) over the row's
       control group; every rank of the row applies them in order, so
       request ids and slots are equal across the row (a request without
       a seed gets one from the leader first, so the row's samplers draw
       alike). Embeddings and checkpoint requests are the leader's own;
    2. the world all-gathers [has_work, stop] (its blocking also matches
       the hosts' rates), and every rank takes the same branch: step,
       idle 0.05 s, or exit once every row has asked to stop and no work
       is left. A host whose own streams are done keeps stepping until
       the world's work drains, so no host leaves a peer mid-collective.

    `multi_step` is ignored: per-host choices between step and
    step_multi could differ, which would misalign the collectives. An
    exception in a tick ends the loop (the world is out of step; its
    peers fail within their control timeout) and fails the open
    requests."""

    def __init__(self, engine, multi_step: int = 0, snapshot_path=None):
        super().__init__(engine, multi_step, snapshot_path)
        self.control = engine.control
        self._exit_agreed = False
        self.failed: Optional[str] = None

    def _should_exit(self) -> bool:
        return self._exit_agreed or self.failed is not None

    def submit(self, ticket: _Ticket) -> int:
        if self.failed is None:
            self.inbox.put(("submit", ticket))
            while not ticket.ready.wait(0.5):
                if self.failed is not None:
                    break
            if ticket.ready.is_set():
                return ticket.request_id
        ticket.request_id = -1
        ticket.events.put(("", True, f"error: {self.failed}", None))
        return -1

    def _checkpoint(self, path, client: bool = False) -> tuple[str, str]:
        if client:
            # a live checkpoint asked of ONE host would write a torn set:
            # the other hosts' files would come from other steps. Only the
            # coordinated shutdown checkpoint (every host exits after the
            # consensus at the same step) is consistent.
            return (
                "error",
                "live /admin/checkpoint is not supported on multi-host "
                "serving; stop all hosts gracefully for a consistent "
                "per-host checkpoint set",
            )
        return super()._checkpoint(path, client=client)

    def _row_ops(self) -> list:
        """The row's operations of this tick, in inbox order: the
        leader's (submit carries its ticket), and the leader's sent to
        the other ranks (submit carries the request)."""
        ops = []
        if self.control.leader:
            shared = len(self.control.row_ranks) > 1
            while True:
                try:
                    kind, payload = self.inbox.get_nowait()
                except queue.Empty:
                    break
                if kind == "submit":
                    req = payload.request
                    if shared and req.seed is None:
                        req.seed = int(np.random.SeedSequence().entropy
                                       % (1 << 63))
                    ops.append(("submit", payload))
                elif kind in ("cancel", "stop"):
                    ops.append((kind, payload))
                elif kind == "embed":
                    inputs, out_q = payload
                    try:
                        out_q.put(("ok", self._embed(inputs)))
                    except Exception as e:  # noqa: BLE001
                        out_q.put(("error", str(e)))
                elif kind == "checkpoint":
                    path, out_q = payload
                    out_q.put(self._checkpoint(path, client=True))
            wire = [(k, p.request if k == "submit" else p) for k, p in ops]
            if shared:
                self.control.broadcast_row(wire)
            return ops
        return self.control.broadcast_row(None)

    def _apply(self, ops: list) -> None:
        for kind, payload in ops:
            if kind == "stop":
                self.stopping = True
            elif kind == "cancel":
                self.engine.cancel(payload)
            elif not isinstance(payload, _Ticket):  # a follower's submit
                if not self.stopping:
                    self.engine.submit(payload)
            elif self.stopping:
                payload.request_id = -1
                payload.events.put(("", True, "error: server stopping",
                                    None))
                payload.ready.set()
            else:
                try:
                    payload.request_id = self.engine.submit(payload.request)
                    self.tickets[payload.request_id] = payload
                except Exception as e:  # noqa: BLE001 — fail THIS request
                    payload.request_id = -1
                    payload.events.put(("", True, f"error: {e}", None))
                payload.ready.set()

    def run(self) -> None:
        try:
            while not self._should_exit():
                self._tick()
        except Exception as e:  # noqa: BLE001 — the world is out of step
            traceback.print_exc()
            self.failed = f"multi-host engine loop failed: {e}"
            self._fail_tickets(f"error: {self.failed}")
            while True:  # submits that raced the failure
                try:
                    kind, payload = self.inbox.get_nowait()
                except queue.Empty:
                    break
                if kind == "submit":
                    payload.request_id = -1
                    payload.events.put(("", True, f"error: {self.failed}",
                                        None))
                    payload.ready.set()
            return
        if self.snapshot_path:
            status, info = self._checkpoint(self.snapshot_path)
            print(f"engine checkpoint on shutdown: {status} {info}",
                  flush=True)

    def _tick(self) -> None:
        self._apply(self._row_ops())
        self._dispatch(self.engine._drain_retired())
        g = self.control.allgather(
            [1 if self.engine.has_work() else 0, 1 if self.stopping else 0],
            "loop")
        work = int(g[:, 0].sum()) > 0
        if bool(g[:, 1].all()) and not work:
            self._exit_agreed = True
            return
        if not work:
            time.sleep(0.05)
            return
        self._dispatch(self.engine.step())


def rank_snapshot_path(engine, path):
    """The checkpoint file of this rank: `path`, or for a multi-host
    engine in a world of more than one rank `<path>.host<N>` (N its
    rank), one file a rank."""
    if hasattr(engine, "has_work_global"):
        import torch.distributed as dist

        if dist.get_world_size() > 1:
            return f"{path}.host{dist.get_rank()}"
    return path


def _restore(engine, path: str, multihost: bool) -> None:
    """Restore `engine` from the checkpoint at `path` when it exists. A
    file the restore refuses is moved to `<path>.corrupt` and the engine
    stays fresh: a refused checkpoint must not stop the server. The ranks
    of a multi-host world agree first: every rank restores, or (a file
    refused, or present on some ranks only) every rank sets its file
    aside and starts fresh, so the ranks of a row hold the same slots and
    the world one step counter."""
    from llm_tpu_torch.engine_snapshot import prepare_engine
    from llm_tpu_torch.session import SnapshotError

    exists = os.path.exists(path)
    commit, reason = None, None
    if exists:
        try:
            commit = prepare_engine(engine, path)
        except SnapshotError as e:
            reason = str(e)
    if multihost:
        absent, _, refused = engine.control.any_world(
            [not exists, commit is not None, reason is not None], "restore")
        if commit is not None and (refused or absent):
            commit = None
            reason = ("another rank's checkpoint was refused" if refused
                      else "another rank has no checkpoint")
    if commit is not None:
        commit()
        print(f"restored engine state from {path} ({engine.active} "
              f"streams in flight, {len(engine.pending)} pending)",
              flush=True)
    elif exists:
        quarantine = f"{path}.corrupt"
        os.replace(path, quarantine)
        print(f"WARNING: engine checkpoint rejected ({reason}); moved to "
              f"{quarantine}, serving with a fresh engine", flush=True)


class LlmServer:
    """Bind an Engine (dense, paged, speculative or multi-host) to an HTTP
    address. A multi-host engine gets the collective per-rank loop, and
    only the leader of its row binds the address."""

    def __init__(self, model, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8080, multi_step: int = 0,
                 default_max_tokens: int = 256, engine_snapshot=None):
        """`engine_snapshot`: the engine checkpoint's path. Restored here
        when the file exists (the streams in flight resume and finish
        headless: their clients went with the old process), written on a
        graceful shutdown, and written live by POST /admin/checkpoint.
        A multi-host engine in a world of more than one rank gets a
        `.host<N>` suffix (N its rank): one file a rank."""
        self.model = model
        self.model_id = getattr(model, "name", None) or "llm-tpu"
        multihost = hasattr(engine, "has_work_global")
        if engine_snapshot is not None:
            engine_snapshot = rank_snapshot_path(engine, engine_snapshot)
        self.engine_snapshot = engine_snapshot
        if engine_snapshot is not None:
            _restore(engine, engine_snapshot, multihost)
        loop_cls = _MultiHostEngineLoop if multihost else _EngineLoop
        self.loop = loop_cls(engine, multi_step=multi_step,
                             snapshot_path=engine_snapshot)
        self.default_max_tokens = default_max_tokens
        self.httpd = None  # a row's other ranks bind no address
        if not multihost or engine.control.leader:
            self.httpd = ThreadingHTTPServer((host, port),
                                             _make_handler(self))
            self.httpd.daemon_threads = True

    @property
    def address(self) -> Optional[tuple[str, int]]:
        if self.httpd is None:
            return None
        return self.httpd.server_address[:2]

    def start(self) -> None:
        self.loop.start()
        if self.httpd is not None:
            threading.Thread(
                target=self.httpd.serve_forever, daemon=True,
                name="llm-tpu-torch-http",
            ).start()

    def shutdown(self) -> None:
        """Stop serving HTTP and the engine loop; waits for both (a
        multi-host loop exits once every row has asked to stop)."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        self.loop.shutdown()
        self.loop.join(timeout=60)

    def warmup(self) -> None:
        """Run one tiny request end to end before the first client arrives,
        so the kernels are built and loaded. Requires the engine loop to be
        running. sampler=None: every engine takes its own default (the
        plain ones the default chain, a greedy-only speculative engine its
        greedy sampler); an engine that requires a device sampler gets
        one, or the submit would fail."""
        dev = None
        if getattr(self.loop.engine, "requires_device_sampler", False):
            dev = DeviceSampler(kind="sample", temperature=1.0)
        gen = self._events(
            GenerationRequest(prompt=[min(2, self.model.spec.n_vocab - 1)],
                              max_tokens=2, device_sampler=dev),
            _StopScanner(None),
        )
        for _ in gen:
            pass
        # warmup shouldn't pollute the serving metrics
        self.loop.stats["requests_completed"] = 0
        self.loop.stats["tokens_generated"] = 0
        self.loop._ttft_ms.clear()

    # -- request plumbing (called from handler threads) ----------------------

    def completion(self, body: dict):
        """Build + validate the request EAGERLY (sampler errors must reach
        the caller as exceptions, not escape a half-started generator),
        then return the (fragment, done, reason, info) iterator."""
        engine = self.loop.engine
        needs_device = getattr(engine, "requires_device_sampler", False)
        if needs_device and body.get("temperature") is None \
                and not body.get("sampler"):
            # a sampled speculative engine needs a device sampler for every
            # request; an omitted temperature means the OpenAI default 1.0
            body = dict(body, temperature=1.0)
        temp = body.get("temperature")
        if getattr(engine, "greedy_only", False) and temp is not None \
                and float(temp) <= 0.0 and not body.get("sampler"):
            # a greedy-only engine forces its own greedy sampler; the
            # equivalent topk:k=1 chain would fail its submit() guard
            sampler = None
        else:
            sampler = sampler_from_params(body,
                                          n_vocab=self.model.spec.n_vocab)
        max_tokens = body.get("max_tokens", self.default_max_tokens)
        req = GenerationRequest(
            prompt=body.get("prompt", ""),
            max_tokens=None if max_tokens in (None, -1) else int(max_tokens),
            sampler=sampler,
            seed=body.get("seed"),
            # a multi-step server decodes in device blocks while every
            # active request's sampling is device-expressible; a sampled
            # speculative engine takes the device sampler every round
            device_sampler=(
                device_sampler_from_params(
                    body, allow_logprobs=engine.supports_device_logprobs,
                    allow_bias=getattr(engine, "supports_device_bias",
                                       True))
                if self.loop.multi_step > 1 or needs_device else None
            ),
            logprobs=(int(body["logprobs"])
                      if body.get("logprobs") is not None else None),
        )
        stops = body.get("stop")
        if isinstance(stops, str):
            stops = [stops]
        return self._events(req, _StopScanner(stops))

    def _events(self, req: GenerationRequest, scan: "_StopScanner"):
        # submit EAGERLY (not at first next()): the handler may build n
        # generators for one request (OpenAI `n`), and the engine can only
        # batch choices whose streams are all in flight
        ticket = _Ticket(request=req)
        rid = self.loop.submit(ticket)
        return _Completion(self.loop, rid, self._drain(ticket, rid, scan))

    def _drain(self, ticket: "_Ticket", rid: int, scan: "_StopScanner"):
        try:
            while True:
                text, done, reason, info = ticket.events.get()
                out = scan.push(text)
                if scan.hit:
                    if out:
                        yield out, False, "", None
                    self.loop.cancel(rid)
                    # drain the queue until the cancel's done-event arrives
                    while not done:
                        _, done, reason, info = ticket.events.get()
                    yield "", True, "stop", info
                    return
                if done:
                    tail = out + scan.flush()  # the done event carries the
                    if tail:                   # final token's text
                        yield tail, False, "", None
                    yield "", True, reason, info
                    return
                if out:
                    yield out, False, "", None
        except GeneratorExit:
            # client went away mid-stream: free the slot
            self.loop.cancel(rid)
            raise


class _Completion:
    """An in-flight completion: iterate for (text, done, reason, info)
    events; close() cancels the ENGINE stream even if iteration never
    started (generator.close() on an unstarted generator skips its body,
    so it alone cannot cancel — with OpenAI `n`, a disconnect during
    choice 0 must still free choices 1..n-1's slots)."""

    __slots__ = ("_loop", "_rid", "_gen")

    def __init__(self, loop, rid, gen):
        self._loop = loop
        self._rid = rid
        self._gen = gen

    def __iter__(self):
        return self._gen

    def close(self) -> None:
        self._loop.cancel(self._rid)
        self._gen.close()


def _finish_name(reason: str) -> str:
    return {
        "eot": "stop", "stop": "stop", "max_tokens": "length",
        "context_full": "length", "cancelled": "cancelled",
    }.get(reason, reason or "stop")


def _make_handler(server: LlmServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                eng = server.loop.engine
                self._json(200, {
                    "status": "ok",
                    "active_streams": eng.active,
                    "pending": len(eng.pending),
                })
            elif self.path == "/metrics":
                self._json(200, server.loop.metrics())
            elif self.path == "/v1/models":
                self._json(200, {
                    "object": "list",
                    "data": [{"id": server.model_id, "object": "model",
                              "owned_by": "llm-tpu"}],
                })
            else:
                self._json(404, {"error": "not found"})

        def _body(self) -> Optional[dict]:
            """The request's JSON object, or None after answering 400."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid JSON body"})
                return None
            if not isinstance(body, dict):
                self._json(400, {"error": "body must be a JSON object"})
                return None
            return body

        def do_POST(self):  # noqa: N802
            if self.path == "/admin/checkpoint":
                body = self._body()
                if body is None:
                    return
                status, info = server.loop.checkpoint(body.get("path"))
                self._json(200 if status == "ok" else 409, {
                    "status": status,
                    ("path" if status == "ok" else "error"): info})
                return
            chat = self.path in ("/v1/chat/completions", "/chat/completions")
            embed = self.path in ("/v1/embeddings", "/embeddings")
            if not (chat or embed) and self.path not in ("/v1/completions",
                                                         "/completions"):
                self._json(404, {"error": "not found"})
                return
            body = self._body()
            if body is None:
                return
            if embed:
                inputs = body.get("input", [])
                if isinstance(inputs, str):
                    inputs = [inputs]
                try:
                    vecs = server.loop.embed(inputs)
                except RuntimeError as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {
                    "object": "list", "model": server.model_id,
                    "data": [{"object": "embedding", "index": i,
                              "embedding": v} for i, v in enumerate(vecs)],
                })
                return
            if chat:
                # the messages rendered to a prompt; the user prefix joins
                # the stop set (the cli chat's convention)
                try:
                    prompt, stop = render_chat(
                        body.get("messages", ()),
                        body.get("chat_template"),
                        getattr(server.model, "chat_template", None),
                    )
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                    return
                stops = body.get("stop") or []
                if isinstance(stops, str):
                    stops = [stops]
                body = dict(body, prompt=prompt, stop=[*stops, stop])
            try:
                n_raw = body.get("n")
                n_choices = 1 if n_raw is None else int(n_raw)
            except (TypeError, ValueError):
                self._json(400, {"error": "n must be an integer"})
                return
            if not 1 <= n_choices <= 64:
                self._json(400, {"error": "n must be in [1, 64]"})
                return
            gens = []
            try:
                # one engine stream per choice, all submitted up front so
                # the engine batches them; an explicit seed derives per-
                # choice seeds (identical seeds would clone every choice)
                for i in range(n_choices):
                    b = body
                    if n_choices > 1 and body.get("seed") is not None:
                        b = dict(body, seed=int(body["seed"]) + i)
                    gens.append(server.completion(b))
            except (SamplerConfigurationError, ValueError, TypeError) as e:
                # a bad sampler combination or malformed numerics anywhere
                # in the body: client errors, all 400s
                for g in gens:  # free any already-submitted choices
                    g.close()
                self._json(400, {"error": str(e)})
                return
            cid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
            if body.get("stream"):
                self._stream(cid, gens, chat)
                return
            choices = []
            for idx, gen in enumerate(gens):
                parts, reason, info = [], "", None
                for text, done, r, inf in gen:
                    if done:
                        reason, info = r, inf
                    elif text:
                        parts.append(text)
                whole = "".join(parts)
                if chat:
                    choice = {"index": idx,
                              "message": {"role": "assistant",
                                          "content": whole.rstrip()},
                              "finish_reason": _finish_name(reason)}
                else:
                    choice = {"index": idx, "text": whole,
                              "finish_reason": _finish_name(reason)}
                if info and info.get("logprobs"):
                    lp = info["logprobs"]
                    choice["logprobs"] = {
                        "tokens": [e["token"] for e in lp],
                        "token_logprobs": [e["logprob"] for e in lp],
                        "top_logprobs": [e.get("top_logprobs") for e in lp],
                    }
                choices.append(choice)
            self._json(200, {
                "id": cid,
                "object": "chat.completion" if chat else "text_completion",
                "model": server.model_id,
                "choices": choices,
            })

        def _chunk(self, cid, chat, text, reason, index=0) -> bytes:
            if chat:
                choice = {"index": index,
                          "delta": {"content": text} if reason is None else {},
                          "finish_reason": reason}
                obj = "chat.completion.chunk"
            else:
                choice = {"index": index, "text": text,
                          "finish_reason": reason}
                obj = "text_completion"
            return b"data: " + json.dumps({
                "id": cid, "object": obj, "model": server.model_id,
                "choices": [choice],
            }).encode() + b"\n\n"

        def _stream(self, cid: str, gens, chat: bool = False) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                # choices stream one after another (each chunk carries its
                # choice index; all n engine streams are already in flight,
                # so draining them in order loses no decode concurrency)
                for idx, gen in enumerate(gens):
                    for text, done, reason, _info in gen:
                        if done:
                            self.wfile.write(self._chunk(
                                cid, chat, "", _finish_name(reason), idx))
                            break
                        if not text:
                            continue
                        self.wfile.write(
                            self._chunk(cid, chat, text, None, idx))
                        self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                for g in gens:  # cancel EVERY choice's engine stream
                    g.close()

    return Handler


def build_engine(model, max_streams=8, kv_dtype=None, n_batch=64,
                 paged=False, page_size=256, n_pages=None,
                 prefix_cache=False, draft=None, draft_k=4,
                 draft_sampled=False, engine_snapshot=None,
                 multihost=False, model_parallel=None) -> Engine:
    """The dense Engine, or a PagedEngine with `paged`; with a `draft`
    model the speculative engine of the same kind (greedy, or rejection
    sampling with `draft_sampled`), proposing `draft_k` tokens a round.
    With `multihost` (an initialized world, `multihost.initialize`) the
    rank's MultiHostEngine or MultiHostPagedEngine over
    `multihost_mesh(model_parallel)`, `max_streams` counting the world's
    slots. kv_dtype defaults to bf16. With `engine_snapshot` the new
    engine is restored from that checkpoint (`engine_snapshot.read_engine`;
    a refused file raises SnapshotError)."""
    kv_dtype = kv_dtype if kv_dtype is not None else torch.bfloat16
    if prefix_cache and (multihost or not paged):
        raise ValueError("--prefix-cache requires --paged (single-host)")
    kwargs = {} if n_pages is None else {"n_pages": n_pages}
    if multihost:
        # one server (and port) a row over the world's mesh; max_streams
        # counts the world's slots, split evenly over the rows
        from llm_tpu_torch.parallel.multihost import (
            MultiHostEngine,
            MultiHostPagedEngine,
            multihost_mesh,
        )

        if draft is not None:
            raise ValueError("--draft-model with --multihost: not yet")
        mesh = multihost_mesh(model_parallel, device=model.device)
        if paged:
            engine = MultiHostPagedEngine(
                model, mesh, global_streams=max_streams, kv_dtype=kv_dtype,
                n_batch=n_batch, page_size=page_size, **kwargs)
        else:
            engine = MultiHostEngine(model, mesh, global_streams=max_streams,
                                     kv_dtype=kv_dtype, n_batch=n_batch)
    elif draft is not None:
        from llm_tpu_torch import speculative as sp

        if paged:
            cls = (sp.PagedSampledSpeculativeEngine if draft_sampled
                   else sp.PagedSpeculativeEngine)
            engine = cls(model, draft, k=draft_k, max_streams=max_streams,
                         kv_dtype=kv_dtype, n_batch=n_batch,
                         page_size=page_size, prefix_cache=prefix_cache,
                         **kwargs)
        else:
            cls = (sp.SampledSpeculativeEngine if draft_sampled
                   else sp.SpeculativeEngine)
            engine = cls(model, draft, k=draft_k, max_streams=max_streams,
                         kv_dtype=kv_dtype, n_batch=n_batch)
    elif paged:
        from llm_tpu_torch.paged import PagedEngine

        engine = PagedEngine(model, max_streams=max_streams,
                             kv_dtype=kv_dtype, page_size=page_size,
                             n_batch=n_batch, prefix_cache=prefix_cache,
                             **kwargs)
    else:
        engine = Engine(model, max_streams=max_streams, kv_dtype=kv_dtype,
                        n_batch=n_batch)
    if engine_snapshot is not None:
        from llm_tpu_torch.engine_snapshot import read_engine

        read_engine(engine, engine_snapshot)
    return engine


def serve_forever(model, host="127.0.0.1", port=8080, max_streams=8,
                  kv_dtype=None, n_batch=64, paged=False, page_size=256,
                  n_pages=None, warmup=True, prefix_cache=False,
                  multi_step=0, draft=None, draft_k=4,
                  draft_sampled=False, engine_snapshot=None,
                  multihost=False, model_parallel=None) -> None:
    """CLI entry: build the engine and serve until interrupted. With
    `engine_snapshot`, the engine is restored from that file when it
    exists (a refused file is set aside; `LlmServer`), and written there
    when the server stops. With `multihost` every rank of the world runs
    this: a row's leader serves HTTP, the row's other ranks run its
    requests, and the world exits once every leader has been stopped."""
    engine = build_engine(model, max_streams, kv_dtype, n_batch, paged,
                          page_size, n_pages, prefix_cache, draft, draft_k,
                          draft_sampled, multihost=multihost,
                          model_parallel=model_parallel)
    srv = LlmServer(model, engine, host=host, port=port,
                    multi_step=multi_step, engine_snapshot=engine_snapshot)
    srv.loop.start()
    if srv.httpd is None:
        # a row's follower: no address; the leader's stop ends its loop
        print(f"llm-tpu-torch rank {engine.mesh.rank} follows its row's "
              f"leader (rank {engine.control.row_ranks[0]})", flush=True)
        while srv.loop.is_alive():
            try:
                srv.loop.join()
            except KeyboardInterrupt:
                pass  # the row stops when its leader does
        _raise_if_failed(srv.loop)
        return
    if warmup:
        print("warming up (building and loading the kernels)...", flush=True)
        t0 = time.monotonic()
        srv.warmup()
        print(f"warmup done in {time.monotonic() - t0:.1f}s", flush=True)
    host, port = srv.address
    print(f"llm-tpu-torch serving {srv.model_id} on http://{host}:{port} "
          f"({'paged' if paged else 'dense'} KV, {max_streams} streams, "
          f"{model.device}"
          + (f", blocks of {multi_step}" if multi_step > 1 else "")
          + (f", draft k={draft_k}" if draft is not None else "")
          + (f", rank {engine.mesh.rank} of {engine.mesh.devices.size} "
             f"on {engine.mesh.backend}" if multihost else "") + ")",
          flush=True)
    if multihost:
        # a failed world loop ends the HTTP server too
        threading.Thread(target=_stop_http_with_loop, args=(srv,),
                         daemon=True).start()
    try:
        srv.httpd.serve_forever()
    finally:
        # a graceful exit (SIGINT) drains the loop, so the final engine
        # checkpoint lands before the process ends; a multi-host loop
        # exits once every row has asked to stop
        srv.loop.shutdown()
        if engine_snapshot is not None or multihost:
            srv.loop.join(timeout=600)
    if multihost:
        _raise_if_failed(srv.loop)


def _stop_http_with_loop(srv: LlmServer) -> None:
    srv.loop.join()
    if srv.loop.failed is not None:
        srv.httpd.shutdown()


def _raise_if_failed(loop) -> None:
    if getattr(loop, "failed", None) is not None:
        raise RuntimeError(loop.failed)
