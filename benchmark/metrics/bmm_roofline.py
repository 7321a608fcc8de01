"""bmm's share of its roofline, in percent: the least time of the serving
path's 1x1 products (counts/bounds.py over the configuration's 1x1 shapes,
bf16) over the device time of the `gemm_kernel` family, both summed over
the profiled stretch's requests. Silent unless the family ran once a 1x1
product of every request."""

import sys

from benchmark.counts.bounds import bmm_bound_s, serving_1x1_shapes

FAMILIES = ("gemm_kernel",)


def read(r):
    if r.kind != "serve":
        return None
    spent, launches = r.trace.family_s(FAMILIES)
    calls = len(serving_1x1_shapes(r.cfg, r.imgsz))
    if launches != calls * r.trace.units or spent <= 0:
        print(f"bmm_roofline: {launches} launches of {FAMILIES} for {r.trace.units} requests of {calls} products: "
              "not read", file=sys.stderr)
        return None
    return 100.0 * bmm_bound_s(r.cfg, r.imgsz, r.batch) * r.trace.units / spent
