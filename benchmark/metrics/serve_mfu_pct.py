"""The served model's operations (counts/flops.py, the one2one branch) of
the profiled stretch's requests, over the device's busy seconds in the
stretch and the H100's 989 TFLOP/s bf16, in percent."""

from benchmark.counts.bounds import BF16_OPS_PER_S
from benchmark.counts.flops import serve_flops


def read(r):
    if r.kind != "serve":
        return None
    ops = serve_flops(r.cfg, r.imgsz) * r.batch * r.trace.units
    return 100.0 * ops / (r.trace.busy_s() * BF16_OPS_PER_S)
