"""Throughput regression gate: compare a bench_matrix run against a recorded
baseline and fail on any cell slower than (1 - threshold) x baseline.

Counterpart of the JAX package's `tools/bench_regression.py`, the same JSON
arithmetic, table and exit codes, so it reads either package's
`bench_matrix --out` files. Exit status: 0 when every compared cell is
within threshold, 1 on any regression or on a baseline cell missing from
the current run (unless the comparison is explicitly narrowed with
--cells).

Example:
    python -m leanyolo_tpu_torch.tools.bench_matrix --out runs/bench_now.json
    python -m leanyolo_tpu_torch.tools.bench_regression --baseline runs/bench_base.json \
        --current runs/bench_now.json --threshold 0.05
"""

from __future__ import annotations

import argparse
import json
import sys


def compare(baseline: dict, current: dict, threshold: float, cells=None):
    """Return (rows, failures). rows = list of per-cell dicts; failures =
    list of human-readable failure strings (regressions + missing cells)."""
    rows, failures = [], []
    base_cells = baseline.get("cells", {})
    cur_cells = current.get("cells", {})
    names = sorted(base_cells) if cells is None else list(cells)
    for name in names:
        if name not in base_cells:
            failures.append(f"{name}: not in baseline")
            continue
        base_ips = float(base_cells[name]["images_per_sec_per_chip"])
        cur = cur_cells.get(name)
        if cur is None:
            failures.append(f"{name}: missing from current run (baseline {base_ips})")
            rows.append({"cell": name, "baseline": base_ips, "current": None,
                         "ratio": None, "status": "MISSING"})
            continue
        cur_ips = float(cur["images_per_sec_per_chip"])
        ratio = cur_ips / base_ips if base_ips > 0 else float("inf")
        ok = ratio >= 1.0 - threshold
        rows.append({"cell": name, "baseline": base_ips, "current": cur_ips,
                     "ratio": round(ratio, 4), "status": "ok" if ok else "REGRESSION"})
        if not ok:
            failures.append(
                f"{name}: {cur_ips} img/s vs baseline {base_ips} "
                f"({(1 - ratio) * 100:.1f}% slower, threshold {threshold * 100:.0f}%)"
            )
    return rows, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", required=True, help="recorded bench_matrix JSON")
    p.add_argument("--current", required=True, help="fresh bench_matrix JSON")
    p.add_argument("--threshold", type=float, default=0.05,
                   help="allowed fractional slowdown per cell (default 0.05)")
    p.add_argument("--cells", default=None,
                   help="comma list of cells to compare (default: every baseline cell)")
    args = p.parse_args(argv)

    with open(args.baseline, encoding="utf-8") as f:
        baseline = json.load(f)
    with open(args.current, encoding="utf-8") as f:
        current = json.load(f)

    cells = [c.strip() for c in args.cells.split(",") if c.strip()] if args.cells else None
    rows, failures = compare(baseline, current, args.threshold, cells)

    print("| cell | baseline | current | ratio | status |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['cell']} | {r['baseline']} | {r['current']} | {r['ratio']} | {r['status']} |")
    improved = [r for r in rows if r["ratio"] and r["ratio"] > 1.0 + args.threshold]
    if improved:
        print(f"\nnote: {len(improved)} cell(s) improved past +{args.threshold * 100:.0f}% — "
              "consider refreshing the baseline to ratchet the gate upward.")
    if failures:
        print("\nPERF REGRESSION GATE FAILED:")
        for msg in failures:
            print(f"  - {msg}")
        return 1
    print(f"\nperf gate PASSED: {len(rows)} cell(s) within {args.threshold * 100:.0f}% of baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
