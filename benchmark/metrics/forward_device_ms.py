"""Device milliseconds a request of the folded model's forward (`Predictor.raw`): the summed durations
of the kernels launched inside its span in the profiled stretch, over the
requests of the stretch."""


def read(r):
    if r.kind != "serve":
        return None
    s = r.trace.span_kernel_s("forward")
    return None if s is None or s <= 0 else s / r.trace.units * 1e3
