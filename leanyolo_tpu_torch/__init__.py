"""PyTorch/CUDA port of leanyolo_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package, with the same layout and
names. It imports torch and numpy only.
"""

from .models.yolov10.model import YOLOv10
from .models.registry import get_model, get_model_weights, list_models
from .engine.predictor import Predictor
from .engine.trainer import TrainConfig, Trainer
from .version import __version__

__all__ = ["YOLOv10", "Predictor", "TrainConfig", "Trainer", "get_model", "get_model_weights", "list_models",
           "__version__"]
