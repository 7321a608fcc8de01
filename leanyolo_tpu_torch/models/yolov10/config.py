"""YOLOv10 variant configurations (n/s/m/b/l/x) as frozen dataclasses.

A copy of the JAX package's `leanyolo_tpu/models/yolov10/config.py:16-106`,
kept here so the port never imports the JAX package. Channel tables, repeat
counts, block-type switches and long-kernel flags are value-for-value the
same, so parameter trees carry across one-to-one (see convert.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping


@dataclass(frozen=True)
class VariantCfg:
    name: str
    ch: Mapping[int, int]  # backbone node channels, indices 0..10
    hch: Mapping[int, int]  # neck fusion node channels, keys 13/16/19/22
    reps: Mapping[int, int]  # repeat counts per node
    types: Mapping[str, str]  # block type per switchable node: "C2f" | "C2fCIB"
    use_lk_c8: bool
    use_lk_p5_p4: bool
    use_lk_p4_p5: bool
    reg_max: int = 16
    strides: tuple = (8, 16, 32)

    @property
    def backbone_out(self) -> tuple:
        """(C3, C4, C5) channel counts."""
        return (self.ch[3], self.ch[5], self.ch[7])

    @property
    def neck_out(self) -> tuple:
        """(P3, P4, P5) channel counts."""
        return (self.hch[16], self.hch[19], self.hch[22])


def _cfg(name, ch, hch, reps, types, lk_c8, lk_p5_p4, lk_p4_p5) -> VariantCfg:
    return VariantCfg(
        name=name,
        ch=dict(ch),
        hch=dict(hch),
        reps=dict(reps),
        types=dict(types),
        use_lk_c8=lk_c8,
        use_lk_p5_p4=lk_p5_p4,
        use_lk_p4_p5=lk_p4_p5,
    )


VARIANTS: Dict[str, VariantCfg] = {
    "yolov10n": _cfg(
        "yolov10n",
        {0: 16, 1: 32, 2: 32, 3: 64, 4: 64, 5: 128, 6: 128, 7: 256, 8: 256, 9: 256, 10: 256},
        {13: 128, 16: 64, 19: 128, 22: 256},
        {2: 1, 4: 2, 6: 2, 8: 1, 13: 1, 16: 1, 19: 1, 22: 1},
        {"c6": "C2f", "c8": "C2f", "p5_p4": "C2f", "p3_p4": "C2f", "p4_p5": "C2fCIB"},
        False, False, True,
    ),
    "yolov10s": _cfg(
        "yolov10s",
        {0: 32, 1: 64, 2: 64, 3: 128, 4: 128, 5: 256, 6: 256, 7: 512, 8: 512, 9: 512, 10: 512},
        {13: 256, 16: 128, 19: 256, 22: 512},
        {2: 1, 4: 2, 6: 2, 8: 1, 13: 1, 16: 1, 19: 1, 22: 1},
        {"c6": "C2f", "c8": "C2fCIB", "p5_p4": "C2f", "p3_p4": "C2f", "p4_p5": "C2fCIB"},
        True, False, True,
    ),
    "yolov10m": _cfg(
        "yolov10m",
        {0: 48, 1: 96, 2: 96, 3: 192, 4: 192, 5: 384, 6: 384, 7: 576, 8: 576, 9: 576, 10: 576},
        {13: 384, 16: 192, 19: 384, 22: 576},
        {2: 2, 4: 4, 6: 4, 8: 2, 13: 2, 16: 2, 19: 2, 22: 2},
        {"c6": "C2f", "c8": "C2fCIB", "p5_p4": "C2f", "p3_p4": "C2fCIB", "p4_p5": "C2fCIB"},
        False, False, False,
    ),
    "yolov10b": _cfg(
        "yolov10b",
        {0: 64, 1: 128, 2: 128, 3: 256, 4: 256, 5: 512, 6: 512, 7: 512, 8: 512, 9: 512, 10: 512},
        {13: 512, 16: 256, 19: 512, 22: 512},
        {2: 2, 4: 4, 6: 4, 8: 2, 13: 2, 16: 2, 19: 2, 22: 2},
        {"c6": "C2f", "c8": "C2fCIB", "p5_p4": "C2fCIB", "p3_p4": "C2fCIB", "p4_p5": "C2fCIB"},
        False, False, False,
    ),
    "yolov10l": _cfg(
        "yolov10l",
        {0: 64, 1: 128, 2: 128, 3: 256, 4: 256, 5: 512, 6: 512, 7: 512, 8: 512, 9: 512, 10: 512},
        {13: 512, 16: 256, 19: 512, 22: 512},
        {2: 3, 4: 6, 6: 6, 8: 3, 13: 3, 16: 3, 19: 3, 22: 3},
        {"c6": "C2f", "c8": "C2fCIB", "p5_p4": "C2fCIB", "p3_p4": "C2fCIB", "p4_p5": "C2fCIB"},
        False, False, False,
    ),
    "yolov10x": _cfg(
        "yolov10x",
        {0: 80, 1: 160, 2: 160, 3: 320, 4: 320, 5: 640, 6: 640, 7: 640, 8: 640, 9: 640, 10: 640},
        {13: 640, 16: 320, 19: 640, 22: 640},
        {2: 3, 4: 6, 6: 6, 8: 3, 13: 3, 16: 3, 19: 3, 22: 3},
        {"c6": "C2fCIB", "c8": "C2fCIB", "p5_p4": "C2fCIB", "p3_p4": "C2fCIB", "p4_p5": "C2fCIB"},
        False, False, False,
    ),
}
