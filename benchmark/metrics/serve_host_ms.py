"""Host milliseconds of one `Predictor.run_batch` call (the enqueue, no
synchronize), the mean over the unprofiled window's requests."""


def read(r):
    return r.host_ms if r.kind == "serve" else None
