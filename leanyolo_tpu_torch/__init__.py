"""PyTorch/CUDA port of leanyolo_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package, with the same layout and
names. It imports torch and numpy only.
"""

from .models.yolov10.model import YOLOv10
from .engine.predictor import Predictor
from .engine.trainer import TrainConfig, Trainer

__all__ = ["YOLOv10", "Predictor", "TrainConfig", "Trainer"]
