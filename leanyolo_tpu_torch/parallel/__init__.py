"""Data parallelism: one process a card, joined by `torch.distributed`.

Counterpart of the JAX package's `leanyolo_tpu/parallel/`: `distributed.py`
starts and serves the process group (NCCL on the card, gloo on the CPU),
`mesh.py` lays the processes out as a `DeviceMesh`, `dryrun.py` runs one
data-parallel train step and both decodes on gloo CPU ranks.
"""
