"""The training BN's batch moments (K8, forward and backward) against their
roofline, in percent: the least time of each training BN's moments and
their backward (counts/bounds.py over the configuration's BN shapes; bf16
maps, fp32 arithmetic) over the device time of the two kernel families,
both summed over the profiled stretch's steps. Silent unless each family
ran once a BN a step."""

import sys

from benchmark.counts.bounds import bn_moments_bound_s

FAMILIES = ("bn_moments_kernel", "bn_moments_bwd_kernel")


def read(r):
    if r.kind != "train":
        return None
    fwd, bwd, calls = bn_moments_bound_s(r.cfg, r.imgsz, r.batch)
    spent, launches = r.trace.family_s(FAMILIES)
    if launches != 2 * calls * r.trace.units or spent <= 0:
        print(f"bn_moments_roofline: {launches} launches of {FAMILIES} for {r.trace.units} steps of {calls} BNs: "
              "not read", file=sys.stderr)
        return None
    return 100.0 * (fwd + bwd) * r.trace.units / spent
