"""Counts the operations of one (GT, anchor) pair of the task-aligned
assignment's candidates kernel from the instructions the card's compiler
emits for it: kernels/bounds.py::TAL_PAIR_OPS (the full chain: CIoU on the
precomputed aspect angles, the sigmoid, sqrt, powf and the alignment) and
TAL_TEST_OPS (what every pair of a valid row costs: the inside test, the
outside pair's skip test and its key).

    python -m leanyolo_tpu_torch.tools.tal_pair_ops [--json out.json]

Needs nvcc and cuobjdump (the CUDA toolkit; $CUDA_HOME, default
/usr/local/cuda): it compiles two probe kernels over csrc/tal.cu's own
device functions with the build's flags into a cubin under build/, and
counts each probe's SASS instructions up to its first EXIT, leaving out
loads, stores, moves, barriers and control flow. The slow paths that the
division and the transcendental functions branch to lie after that EXIT and
are not counted.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
from pathlib import Path

from ..kernels._build import BUILD_DIR, CUDA_FLAGS, _CSRC

PROBES = r'''
#include "tal.cu"

extern "C" __global__ void probe_chain(const float* in, float* out) {
  const Box g{in[0], in[1], in[2], in[3]}, pb{in[4], in[5], in[6], in[7]};
  const float o = ciou_at(g, pb, in[8], in[9], in[10]);
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-in[11])));
  const float t = __fmul_rn(__fsqrt_rn(clamp01(s)), powf(clamp01(o), in[12]));
  const float al = __fmul_rn(t, in[13] != 0.0f ? 1.0f : 0.0f);
  out[0] = o;
  reinterpret_cast<unsigned long long*>(out)[1] =
      (static_cast<unsigned long long>(order_bits(al)) << 32) | (0xFFFFFFFFu - __float_as_uint(in[14]));
}

extern "C" __global__ void probe_test(const float* in, const int* flags, unsigned long long* out) {
  const Box g{in[0], in[1], in[2], in[3]};
  const bool in_box = flags[0] && inside(in[4], in[5], g);
  const bool full = flags[1] || in_box || !(flags[2] && flags[3] && !flags[4]);
  out[0] = full ? 1ull : (static_cast<unsigned long long>(order_bits(0.0f)) << 32) | (0xFFFFFFFFu - flags[5]);
}
'''

# Not operations: memory, moves, barriers, control flow, special registers.
NOT_OPS = re.compile(r"^(LD|ST|ULD|UST|MOV|UMOV|IMAD\.MOV|S2R|S2UR|CS2R|BAR|BRA|EXIT|NOP|RET|CALL|BSSY|BSYNC|"
                     r"WARPSYNC|BMOV|ULDC|LDC|MEMBAR|DEPBAR|YIELD)")


def count(sass: str, name: str) -> dict:
    """{"ops": n, "by_opcode": {...}} of function `name` in cuobjdump's
    listing, up to its first EXIT."""
    body = sass.split(f"Function : {name}", 1)[1]
    ops, by = 0, {}
    for line in body.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if not m:
            continue
        op = m.group(2)
        if op.startswith("EXIT"):
            break
        if NOT_OPS.match(op):
            continue
        ops += 1
        base = op.split(".")[0]
        by[base] = by.get(base, 0) + 1
    return {"ops": ops, "by_opcode": dict(sorted(by.items()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the counts here too")
    args = ap.parse_args(argv)
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    out = BUILD_DIR.parent / "tal_pair_ops"
    out.mkdir(parents=True, exist_ok=True)
    src, cubin = out / "probe.cu", out / "probe.cubin"
    src.write_text(PROBES)
    flags = [f for f in CUDA_FLAGS if not f.startswith("-U")]
    subprocess.run([str(cuda / "bin" / "nvcc"), *flags, "-cubin", "-I", str(_CSRC), "-o", str(cubin), str(src)],
                   check=True)
    sass = subprocess.run([str(cuda / "bin" / "cuobjdump"), "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    res = {"chain": count(sass, "probe_chain"), "test": count(sass, "probe_test"), "flags": flags}
    print(f"TAL_PAIR_OPS (the chain) {res['chain']['ops']}: {res['chain']['by_opcode']}")
    print(f"TAL_TEST_OPS (every pair) {res['test']['ops']}: {res['test']['by_opcode']}")
    if args.json:
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
