"""Append-only CSV log of validation runs.

Counterpart of the JAX package's `leanyolo_tpu/utils/val_log.py`, a copy
kept so the port never imports the JAX package: the same 27-column schema,
the same self-migrating header and the same rows. The port writes
`runtime` 'torch'; a 'cuda' device is named by torch.
"""

from __future__ import annotations

import contextlib
import csv
import os
import platform
import socket
import subprocess
from datetime import UTC, datetime
from pathlib import Path
from typing import Dict, Iterable, List, Mapping

# Canonical 27-column run-log schema (order matters; appended rows and header
# migrations both key off this tuple).
COLUMNS: List[str] = [
    "timestamp",
    "run_id",
    "commit",
    "host",
    "runtime",  # jax | torch | onnxrt | tensorrt | torchscript
    "precision",  # fp32 | bf16 | fp16 | int8
    "device",  # cpu | tpu | cuda
    "device_name",
    "model",
    "weights",
    "dataset",
    "images_dir",
    "ann_json",
    "split",
    "n_images",
    "imgsz",
    "conf",
    "iou",
    "max_images",
    "map_50_95",
    "map_50",
    "map_75",
    "fps",
    "export_path",
    "detections_json",
    "viz_dir",
    "notes",
]


def now_iso() -> str:
    """UTC timestamp in second resolution, Z-suffixed."""
    return datetime.now(UTC).replace(microsecond=0).isoformat().replace("+00:00", "Z")


def collect_env_info(*, device: str) -> Dict[str, str]:
    """Environment columns for a run row: commit, host, device, device_name.
    A 'cuda' device is named by torch (the card's name); any other by the
    host's processor."""
    if (device or "").lower().startswith("cuda"):
        import torch

        name = torch.cuda.get_device_name(0)
    else:
        name = platform.processor() or platform.machine() or "cpu"

    # The commit of this checkout: none outside a git work tree, or where
    # git is not installed.
    commit = ""
    with contextlib.suppress(FileNotFoundError):
        proc = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode == 0:
            commit = proc.stdout.strip()

    return {
        "commit": commit,
        "host": socket.gethostname(),
        "device": device,
        "device_name": name,
    }


def _read_rows(path: Path) -> tuple[List[str], List[Dict[str, str]]] | None:
    """Parse an existing log as (header, row dicts); None if unreadable/empty."""
    try:
        with path.open("r", newline="", encoding="utf-8") as f:
            reader = csv.DictReader(f)
            if not reader.fieldnames:
                return None
            rows = [dict(r) for r in reader]
        return list(reader.fieldnames), rows
    except (OSError, csv.Error, UnicodeDecodeError):
        return None


def _write_rows(path: Path, columns: List[str], rows: Iterable[Mapping[str, object]]) -> None:
    with path.open("w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=columns, extrasaction="ignore", restval="")
        writer.writeheader()
        for row in rows:
            writer.writerow({k: v for k, v in row.items() if k is not None})


def ensure_csv(path: Path) -> None:
    """Create the log with a schema header, or migrate an old-schema log.

    Migration keeps every row, matching columns by name: renamed-away columns
    drop, new columns fill empty — so the file is always readable under the
    current schema.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    if not path.exists():
        _write_rows(path, COLUMNS, [])
        return

    parsed = _read_rows(path)
    if parsed is None:
        _write_rows(path, COLUMNS, [])  # unreadable/empty: start fresh
        return
    header, rows = parsed
    if header != COLUMNS:
        _write_rows(path, COLUMNS, rows)


def append_row(path: Path, values: Mapping[str, object]) -> None:
    """Append one run row; creates/migrates the file first. Unknown keys in
    `values` are ignored, missing ones become empty cells."""
    path = Path(path)
    ensure_csv(path)
    with path.open("a", newline="", encoding="utf-8") as f:
        csv.DictWriter(f, fieldnames=COLUMNS, extrasaction="ignore", restval="").writerow(
            {c: values.get(c, "") for c in COLUMNS}
        )
