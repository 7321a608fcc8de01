"""Parallelism: one process a card, joined by `torch.distributed`.

Counterpart of the JAX package's `leanyolo_tpu/parallel/`: `distributed.py`
starts and serves the process group (NCCL on the card, gloo on the CPU),
`mesh.py` lays the processes out as a `DeviceMesh` (data, hybrid, space and
model meshes), `spatial.py` splits each image's rows over `space` with halo
exchanges, `tensor.py` each layer's output channels over `model`, and
`dryrun.py` runs one data-parallel train step and both decodes on gloo CPU
ranks (with 4 or more, the space and model legs too).
"""
