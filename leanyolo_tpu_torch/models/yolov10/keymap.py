"""Official YOLOv10 checkpoint key mapping tables.

Maps official `model.{idx}.` prefixes of THU-MIG/ultralytics-format
checkpoints to the port's module names. A copy of the JAX package's
`leanyolo_tpu/models/yolov10/keymap.py`, kept here so the port never
imports the JAX package; the port's module names are the JAX tree's.
"""

from __future__ import annotations

from typing import Dict, Optional

BACKBONE_MAP: Dict[int, str] = {
    0: "backbone.cv0",
    1: "backbone.cv1",
    2: "backbone.c2",
    3: "backbone.cv3",
    4: "backbone.c4",
    5: "backbone.sc5",
    6: "backbone.c6",
    7: "backbone.sc7",
    8: "backbone.c8",
    9: "backbone.sppf9",
    10: "backbone.psa10",
}

NECK_MAP: Dict[int, str] = {
    13: "neck.p5_p4_c2f",
    16: "neck.p4_p3_c2f",
    17: "neck.p3_down",
    19: "neck.p3_p4_c2f",
    20: "neck.p4_down",
    22: "neck.p4_p5_c2f",
}

HEAD_MAP: Dict[int, str] = {
    23: "head",
}

# RepVGGDW blocks inside CIBs: *fused* official checkpoints store the single
# merged conv as `cv1.2.conv.*` / `cv1.2.bn.*` while the unfused architecture
# names it `cv1.2.conv.conv.*` / `cv1.2.conv.bn.*`.
REPVGGDW_FUSED_ALT = {
    ".cv1.2.conv.weight": ".cv1.2.conv.conv.weight",
    ".cv1.2.bn.weight": ".cv1.2.conv.bn.weight",
    ".cv1.2.bn.bias": ".cv1.2.conv.bn.bias",
    ".cv1.2.bn.running_mean": ".cv1.2.conv.bn.running_mean",
    ".cv1.2.bn.running_var": ".cv1.2.conv.bn.running_var",
}


def official_key_to_lean(key: str) -> Optional[str]:
    """Translate one official `model.{idx}.rest` key to a lean dotted name.

    Returns None for keys outside the mapped graph (e.g. model.11/12 concat
    nodes, which hold no parameters).
    """
    if not key.startswith("model."):
        return None
    parts = key.split(".", 2)
    if len(parts) < 3:
        return None
    try:
        idx = int(parts[1])
    except ValueError:
        return None
    for table in (BACKBONE_MAP, NECK_MAP, HEAD_MAP):
        if idx in table:
            return table[idx] + "." + parts[2]
    return None
