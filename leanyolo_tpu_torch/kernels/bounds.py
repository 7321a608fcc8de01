"""Least times an H100 could take for the TPU kernels still to be ported, at
the shapes their probes run (bytes over 3.35 TB/s against operations over
989 TFLOP/s bf16; each input read once, each output written once).

    python -m leanyolo_tpu_torch.kernels.bounds

Arithmetic from shapes only: it runs anywhere and measures nothing.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12


def bound(nbytes: float, nops: float):
    """(ms, 'bytes' or 'operations') for work moving nbytes and doing nops bf16 ops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def probe_bounds():
    """Rows of (kernel, shape, MB moved, GFLOP, bound ms, bound by)."""
    rows = []
    # experiments/exp_pallas_k2.py (and the k2b variants): 2x2 VALID conv on
    # the space-to-depth form, x [128,81,81,128] bf16, w [4,128,128] bf16 ->
    # [128,80,80,128] bf16.
    b = 128
    nbytes = 2 * (b * 81 * 81 * 128 + 4 * 128 * 128 + b * 80 * 80 * 128)
    nops = 2 * b * 80 * 80 * 128 * (4 * 128)
    rows.append(("pallas_k2 / k2b", "[128,81,81,128] x [4,128,128]", nbytes, nops, *bound(nbytes, nops)))
    # experiments/exp_pallas_mm.py: [128,M,K] x [K,N] -> [128,M,N] bf16.
    for m, k, n in ((6400, 128, 128), (6400, 512, 128), (3200, 512, 128), (1600, 512, 128), (1600, 512, 512)):
        nbytes = 2 * (b * m * k + k * n + b * m * n)
        nops = 2 * b * m * k * n
        rows.append(("pallas_mm", f"M{m} K{k} N{n}", nbytes, nops, *bound(nbytes, nops)))
    return rows


if __name__ == "__main__":
    for name, shape, nbytes, nops, ms, by in probe_bounds():
        print(f"{name:16s} {shape:32s} {nbytes / 1e6:9.2f} MB {nops / 1e9:9.2f} GFLOP  bound {ms:.5f} ms ({by})")
