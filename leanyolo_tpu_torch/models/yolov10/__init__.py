from .model import YOLOv10
from .config import VARIANTS, VariantCfg

__all__ = ["YOLOv10", "VARIANTS", "VariantCfg"]
