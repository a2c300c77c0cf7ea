"""HTTP serving front-end over the continuous-batching engine.

The counterpart of `llm_tpu/server.py`: an OpenAI-style REST API on the
stdlib `http.server`, so it adds no dependencies.

  POST /v1/completions   {"prompt", "max_tokens", "temperature", "top_k",
                          "top_p", "seed", "stop", "stream", "n",
                          "logprobs", "logit_bias", ...}
                         non-stream -> one JSON body; "stream": true ->
                         server-sent events, one data: line per UTF-8
                         fragment, closing with data: [DONE]
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

Not ported yet: chat completions, embeddings, engine checkpoints and the
admin endpoint, speculative and multi-host engines.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

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


def device_sampler_from_params(params: dict, allow_logprobs: bool = False):
    """A DeviceSampler for a request the device can sample (greedy or
    temperature, with top-k, top-p, min-p, tail-free, typical or mirostat,
    windowed repetition / frequency / presence penalties and logit bias),
    so a multi-step server decodes it in blocks. None when the request
    needs the host chain: an explicit sampler DSL, no temperature (the
    full default chain), logprobs unless `allow_logprobs`."""
    if params.get("sampler") is not None:
        return None
    if params.get("logprobs") is not None and not allow_logprobs:
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

    def __init__(self, engine: Engine, multi_step: int = 0):
        super().__init__(daemon=True, name="llm-tpu-torch-engine")
        self.engine = engine
        self.multi_step = multi_step
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
            elif kind == "stop":
                self.stopping = True

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

    def run(self) -> None:
        while not self.stopping:
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — an engine failure must not
                # strand waiting handlers on a dead thread: fail their
                # requests and keep serving
                traceback.print_exc()
                tickets, self.tickets = self.tickets, {}
                for t in tickets.values():
                    t.events.put(("", True, "error: engine step failed", None))

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


class LlmServer:
    """Bind an Engine (dense or paged) to an HTTP address."""

    def __init__(self, model, engine: Engine, host: str = "127.0.0.1",
                 port: int = 8080, multi_step: int = 0,
                 default_max_tokens: int = 256):
        self.model = model
        self.model_id = getattr(model, "name", None) or "llm-tpu"
        self.loop = _EngineLoop(engine, multi_step=multi_step)
        self.default_max_tokens = default_max_tokens
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> None:
        self.loop.start()
        threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name="llm-tpu-torch-http",
        ).start()

    def shutdown(self) -> None:
        """Stop serving HTTP and the engine loop; waits for both."""
        self.httpd.shutdown()
        self.httpd.server_close()
        self.loop.shutdown()
        self.loop.join(timeout=60)

    def warmup(self) -> None:
        """Run one tiny request end to end before the first client arrives,
        so the kernels are built and loaded. Requires the engine loop to be
        running."""
        gen = self._events(
            GenerationRequest(prompt=[min(2, self.model.spec.n_vocab - 1)],
                              max_tokens=2),
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
        sampler = sampler_from_params(body, n_vocab=self.model.spec.n_vocab)
        max_tokens = body.get("max_tokens", self.default_max_tokens)
        req = GenerationRequest(
            prompt=body.get("prompt", ""),
            max_tokens=None if max_tokens in (None, -1) else int(max_tokens),
            sampler=sampler,
            seed=body.get("seed"),
            # a multi-step server decodes in device blocks while every
            # active request's sampling is device-expressible
            device_sampler=(
                device_sampler_from_params(
                    body, allow_logprobs=(
                        self.loop.engine.supports_device_logprobs))
                if self.loop.multi_step > 1 else None
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

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/completions", "/completions"):
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid JSON body"})
                return
            if not isinstance(body, dict):
                self._json(400, {"error": "body must be a JSON object"})
                return
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
            cid = f"cmpl-{uuid.uuid4().hex[:24]}"
            if body.get("stream"):
                self._stream(cid, gens)
                return
            choices = []
            for idx, gen in enumerate(gens):
                parts, reason, info = [], "", None
                for text, done, r, inf in gen:
                    if done:
                        reason, info = r, inf
                    elif text:
                        parts.append(text)
                choice = {"index": idx, "text": "".join(parts),
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
                "object": "text_completion",
                "model": server.model_id,
                "choices": choices,
            })

        def _chunk(self, cid, text, reason, index=0) -> bytes:
            return b"data: " + json.dumps({
                "id": cid, "object": "text_completion",
                "model": server.model_id,
                "choices": [{"index": index, "text": text,
                             "finish_reason": reason}],
            }).encode() + b"\n\n"

        def _stream(self, cid: str, gens) -> None:
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
                                cid, "", _finish_name(reason), idx))
                            break
                        if not text:
                            continue
                        self.wfile.write(self._chunk(cid, text, None, idx))
                        self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                for g in gens:  # cancel EVERY choice's engine stream
                    g.close()

    return Handler


def build_engine(model, max_streams=8, kv_dtype=None, n_batch=64,
                 paged=False, page_size=256, n_pages=None,
                 prefix_cache=False) -> Engine:
    """The dense Engine, or a PagedEngine with `paged`; kv_dtype defaults
    to bf16."""
    kv_dtype = kv_dtype if kv_dtype is not None else torch.bfloat16
    if prefix_cache and not paged:
        raise ValueError("--prefix-cache requires --paged")
    if paged:
        from llm_tpu_torch.paged import PagedEngine

        kwargs = {} if n_pages is None else {"n_pages": n_pages}
        return PagedEngine(model, max_streams=max_streams,
                           kv_dtype=kv_dtype, page_size=page_size,
                           n_batch=n_batch, prefix_cache=prefix_cache,
                           **kwargs)
    return Engine(model, max_streams=max_streams, kv_dtype=kv_dtype,
                  n_batch=n_batch)


def serve_forever(model, host="127.0.0.1", port=8080, max_streams=8,
                  kv_dtype=None, n_batch=64, paged=False, page_size=256,
                  n_pages=None, warmup=True, prefix_cache=False,
                  multi_step=0) -> None:
    """CLI entry: build the engine and serve until interrupted."""
    engine = build_engine(model, max_streams, kv_dtype, n_batch, paged,
                          page_size, n_pages, prefix_cache)
    srv = LlmServer(model, engine, host=host, port=port,
                    multi_step=multi_step)
    srv.loop.start()
    if warmup:
        print("warming up (building and loading the kernels)...", flush=True)
        t0 = time.monotonic()
        srv.warmup()
        print(f"warmup done in {time.monotonic() - t0:.1f}s", flush=True)
    host, port = srv.address
    print(f"llm-tpu-torch serving {srv.model_id} on http://{host}:{port} "
          f"({'paged' if paged else 'dense'} KV, {max_streams} streams, "
          f"{model.device}"
          + (f", blocks of {multi_step}" if multi_step > 1 else "") + ")",
          flush=True)
    try:
        srv.httpd.serve_forever()
    finally:
        srv.loop.shutdown()
