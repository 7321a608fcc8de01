"""The port's CSV run log (`leanyolo_tpu_torch/utils/val_log.py`) against
the JAX package's, and the port's validation CLI
(`python -m leanyolo_tpu_torch.tools.val`) run in-process on the CPU."""

from __future__ import annotations

import csv
import json

import pytest

from leanyolo_tpu.utils import val_log as jval_log
from leanyolo_tpu_torch.tools import val as val_cli
from leanyolo_tpu_torch.utils import val_log
from synth_coco import make_synth_coco

ROWS = [
    {"timestamp": "2026-01-02T03:04:05Z", "run_id": "a1", "model": "yolov10n", "map_50_95": "0.12345",
     "notes": "comma, quote \" and newline\nkept"},
    {"run_id": "b2", "n_images": 5, "fps": "12.5", "unknown_key": "ignored"},
]


def test_columns_equal_jax():
    assert val_log.COLUMNS == jval_log.COLUMNS and len(val_log.COLUMNS) == 27


@pytest.mark.parametrize("start", ["none", "empty", "current", "old"])
def test_csv_files_equal_jax(tmp_path, start):
    """append_row (through ensure_csv) writes byte for byte the file JAX's
    writes, from no file, an empty file, a current-schema file, and an
    old-schema file whose header is migrated (renamed-away columns drop,
    new ones fill empty)."""
    paths = []
    for pkg in ("port", "jax"):
        p = tmp_path / pkg / "log.csv"
        p.parent.mkdir()
        if start == "empty":
            p.write_text("")
        elif start == "current":
            val_log.ensure_csv(p)
        elif start == "old":
            p.write_text("timestamp,run_id,model,mAP,fps\n2025-01-01T00:00:00Z,old1,yolov10s,0.4,33.0\n")
        paths.append(p)
    for p, mod in zip(paths, (val_log, jval_log)):
        for row in ROWS:
            mod.append_row(p, row)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    with paths[0].open(newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == val_log.COLUMNS and all(len(r) == 27 for r in rows)
    assert len(rows) == 1 + len(ROWS) + (start == "old")


def test_collect_env_info_on_the_cpu():
    env = val_log.collect_env_info(device="cpu")
    assert set(env) == {"commit", "host", "device", "device_name"}
    assert env["device"] == "cpu" and env["device_name"]


def test_cli_on_the_cpu(tmp_path, capsys):
    img_dir, ann = make_synth_coco(str(tmp_path / "coco"), n_images=3)
    log = tmp_path / "runs" / "val_log.csv"
    dets = tmp_path / "dets.json"
    val_cli.main(["--model", "yolov10n", "--weights", "none", "--images-dir", img_dir, "--ann-json", ann,
                  "--imgsz", "64", "--batch-size", "2", "--workers", "2", "--device", "cpu", "--log-csv", str(log),
                  "--save-detections", str(dets), "--run-id", "cli1", "--measure-fps", "--notes", "cpu run"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("mAP50-95="))
    assert " images=3 " in line and " fps=" in line
    assert f"logged: {log}" in out
    with log.open(newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and len(rows[0]) == 27
    row = rows[0]
    assert (row["runtime"], row["device"], row["precision"], row["run_id"]) == ("torch", "cpu", "fp32", "cli1")
    assert (row["model"], row["weights"], row["n_images"], row["imgsz"]) == ("yolov10n", "none", "3", "64")
    assert row["map_50_95"] == line.split()[0].split("=")[1] and row["detections_json"] == str(dets)
    assert len(json.loads(dets.read_text())) == 3 * 84  # top-k keeps min(300, anchors): 8x8 + 4x4 + 2x2


def test_cli_data_root_without_annotations_exits(tmp_path):
    """No annotations under --data-root: the CLI exits and says so; it does
    not create the root or reach for COCO val2017 as the JAX CLI's download
    would."""
    root = tmp_path / "coco"
    with pytest.raises(SystemExit, match="not ported"):
        val_cli.main(["--data-root", str(root), "--weights", "none", "--device", "cpu"])
    assert not root.exists()


def test_cli_resolves_a_data_root(tmp_path):
    img_dir, ann = make_synth_coco(str(tmp_path / "coco"), n_images=1)
    args = val_cli.parse_args(["--data-root", str(tmp_path / "coco")])
    assert val_cli.resolve_dataset(args) == (img_dir, ann)
    assert args.device == "cuda" and args.dtype == "float32" and args.batch_size == 16
