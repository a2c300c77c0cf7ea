"""The "session" driver: one `InferenceSession` a request through
`infer_device`, one closed-loop client (it sends its next request when the
last one has ended). Each session is handed the KV buffer the first one
made, as a server reuses a slot's cache: the port keys its captured graphs
by the cache object, so a fresh buffer a request would capture every graph
again inside the window.

A driver (`portbench/drivers/<name>.py`, named by a traffic file's
`driver`) defines `Driver(model, settings, traffic, requests, timeline)`
with `warm()` (capture every graph key its traffic can reach, before the
window; returns how many), `call(work=None)` (one call of the timed path,
its requests recorded in the Timeline, and with a `roofline.Work` the
work it needed counted), `run_until(t_close)`, `drain(t_cap, sample)`,
`free()` and `calls`, the (start, end) host times of its calls.
"""

from __future__ import annotations

import time

from portbench.roofline import Work
from portbench.weights import EOT_ID
from portbench.window import Rec, Timeline


def _sampler(ban_eot: bool):
    from llm_tpu_torch.ops.sampling import DeviceSampler

    if ban_eot:
        return DeviceSampler(kind="greedy", bias=((EOT_ID, float("-inf")),))
    return DeviceSampler.greedy()


class Driver:
    def __init__(self, model, settings: dict, traffic: dict, requests,
                 tl: Timeline):
        self.model, self.s = model, settings
        self.traffic, self.requests, self.tl = traffic, requests, tl
        self.sampler = _sampler(settings["ban_eot"])
        self.cache = None
        self.next = 0
        self.calls: list = []

    def _session(self):
        from llm_tpu_torch.session import (InferenceSession,
                                           InferenceSessionConfig,
                                           ModelKVMemoryType)

        if self.s["kv"] != "bf16":
            raise ValueError("the session cell's KV is bf16")
        cfg = InferenceSessionConfig(
            memory_k_type=ModelKVMemoryType.Float16,
            memory_v_type=ModelKVMemoryType.Float16,
            n_batch=self.s["n_batch"])
        sess = InferenceSession(self.model, cfg)
        if self.cache is None:
            self.cache = sess.cache
        else:
            sess.cache = self.cache
        return sess

    def request(self, prompt, max_tokens: int, index: int = -1,
                work: Work = None) -> Rec:
        sess = self._session()
        rec = Rec(index, time.monotonic(), max_tokens, tuple(prompt))
        n_prompt = len(prompt)
        seen = [0]

        def cb(_text):
            t = time.monotonic()
            got = len(sess.tokens) - n_prompt
            if got > seen[0]:
                if rec.t_first is None:
                    rec.t_first = t
                self.tl.deliver(t, got - seen[0])
                seen[0] = got

        try:
            sess.infer_device(list(prompt), max_tokens, sampler=self.sampler,
                              n_steps=self.s["block"], callback=cb,
                              halt_on_eot=self.s["halt_on_eot"])
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            rec.error = f"{type(e).__name__}: {e}"
        t = time.monotonic()
        got = len(sess.tokens) - n_prompt
        if got > seen[0]:
            self.tl.deliver(t, got - seen[0])
            if rec.t_first is None:
                rec.t_first = t
        rec.t_done = t
        rec.tokens = list(sess.tokens[n_prompt:])
        if work is not None:
            work.prefill.append((0, n_prompt))
            work.add_block([(n_prompt, got)])
        self.calls.append((rec.t_sent, t))
        return rec

    def call(self, work: Work = None) -> None:
        req = self.requests.get(self.next)
        self.next += 1
        self.tl.recs.append(self.request(req.prompt, req.max_tokens,
                                         req.index, work))

    def capture_all(self) -> int:
        """Capture every decode graph the traffic can reach: a one-block
        request for each window a first block can land in, then the
        longest prompt with the longest output, whose blocks pass through
        every later window. Their records are not the traffic's. Every
        output is whole blocks, so every block has the same capacity (a
        graph key each)."""
        from llm_tpu_torch.models.forward import window_bucket

        spec = self.model.spec
        blk = self.s["block"]
        if any(o % blk for _, o in self.requests.pairs):
            raise ValueError(f"session outputs must be whole blocks of {blk}")
        (lo, _), (hi, top_o) = self.requests.minima(), self.requests.maxima()
        first = {}
        for p in range(lo, hi + 1):
            first.setdefault(window_bucket(p + blk, spec.n_ctx), p)
        runs = [(p, blk) for p in sorted(first.values())] + [(hi, top_o)]
        tl, self.tl = self.tl, Timeline()
        try:
            for p, n in runs:
                self.request([1 + i % (spec.n_vocab - 1) for i in range(p)],
                             n)
        finally:
            self.tl = tl
        return len(runs)

    def warm(self) -> int:
        keys = self.capture_all()
        self.call()
        return keys

    def run_until(self, t_close: float) -> float:
        while True:
            self.call()
            if self.calls[-1][1] >= t_close:
                return self.calls[-1][1]

    def drain(self, t_cap: float, sample) -> None:
        pass  # each request ends inside its own call

    def free(self) -> None:
        self.cache = None
        self.model = None

