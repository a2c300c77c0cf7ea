"""95th percentile of the time to first token of the window's requests
through `InferenceSession.infer_device`."""


def read(run):
    if run.driver != "session":
        return None
    return run.p95(run.tl.ttft_ms())
