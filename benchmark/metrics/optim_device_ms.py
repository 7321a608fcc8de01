"""Device milliseconds a step of the clip and AdamW (`Trainer.optimizer_step`): the summed durations
of the kernels launched inside its span in the profiled stretch, over the
steps of the stretch."""


def read(r):
    if r.kind != "train":
        return None
    s = r.trace.span_kernel_s("optimizer_step")
    return None if s is None or s <= 0 else s / r.trace.units * 1e3
