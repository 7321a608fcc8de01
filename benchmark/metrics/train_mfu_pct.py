"""The trained model's operations (counts/flops.py: three times the forward
through both head branches an image) of the profiled stretch's steps, over
the device's busy seconds in the stretch and the H100's 989 TFLOP/s bf16,
in percent."""

from benchmark.counts.bounds import BF16_OPS_PER_S
from benchmark.counts.flops import train_flops


def read(r):
    if r.kind != "train":
        return None
    ops = train_flops(r.cfg, r.imgsz) * r.batch * r.trace.units
    return 100.0 * ops / (r.trace.busy_s() * BF16_OPS_PER_S)
