"""The port's bench CLIs (`leanyolo_tpu_torch.tools.{bench, bench_train,
bench_matrix, bench_regression}`) against the JAX package's, on the CPU at
a size that runs in seconds (yolov10n, 64 px, batch 2, short chains).

What is held:
- bench_regression: `compare` and `main` give tools/bench_regression.py's
  rows, failures, exit codes and printed table, over a regression, a cell
  missing from the current run, a narrowed comparison, an improved cell and
  a zero baseline;
- bench_matrix: with the same bench functions under both, the JSON lines
  (JAX's keys and values, and the device), the table and the `--out` file
  (JAX's schema, and the device and card) are tools/bench_matrix.py's in
  both key formats, and either package's `compare` reads the other's file;
  a real run on the CPU writes that schema; a cell with no batch size that
  fitted raises;
- bench_train's synthetic batch is bench_train.py:38-47's draw;
- bench_latency's fit is bench.py:172-175's formula;
- `torch.OutOfMemoryError` at the second batch size keeps the first and
  ends the sweep, while any other error propagates;
- with no card, the entries raise on their default device;
- the timed serving call is `Predictor(fuse=True, dtype="bfloat16")` with
  the bench's decode constants, and its detections are those of a
  predictor built so on the same batch;
- the new modules import neither JAX nor the JAX package.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from leanyolo_tpu_torch.engine.predictor import Predictor
from leanyolo_tpu_torch.tools import bench, bench_matrix, bench_regression, bench_train
from leanyolo_tpu_torch.utils import profiling
from tools import bench_matrix as jbench_matrix
from tools import bench_regression as jbench_regression

REPO = Path(__file__).resolve().parents[1]


def _cells(**ips):
    return {"imgsz": 640, "cells": {k.replace("__", "/"): {"images_per_sec_per_chip": v, "batch_size": 32,
                                                           "per_bs": {"32": v}} for k, v in ips.items()}}


# name: (baseline, current, extra CLI flags)
REG_CASES = {
    "regression": (_cells(yolov10s__infer=100.0, yolov10s__train=50.0),
                   _cells(yolov10s__infer=90.0, yolov10s__train=50.0), []),
    "missing_cell": (_cells(yolov10s__infer=100.0, yolov10n__infer=200.0), _cells(yolov10s__infer=100.0), []),
    "narrowed_cells": (_cells(yolov10s__infer=100.0, yolov10n__infer=200.0), _cells(yolov10s__infer=97.0),
                       ["--cells", "yolov10s/infer"]),
    "improved_cell": (_cells(yolov10s__infer=100.0, yolov10s__nms=80.0),
                      _cells(yolov10s__infer=130.0, yolov10s__nms=80.0), ["--threshold", "0.1"]),
    "zero_baseline": (_cells(yolov10s__infer=0.0), _cells(yolov10s__infer=12.5), []),
}


@pytest.mark.parametrize("case", list(REG_CASES))
def test_bench_regression_matches_jax(case, tmp_path, capsys):
    base, cur, flags = REG_CASES[case]
    cells = flags[1].split(",") if flags[:1] == ["--cells"] else None
    assert bench_regression.compare(base, cur, 0.05, cells) == jbench_regression.compare(base, cur, 0.05, cells)
    paths = []
    for name, table in (("base", base), ("cur", cur)):
        paths.append(tmp_path / f"{name}.json")
        paths[-1].write_text(json.dumps(table))
    argv = ["--baseline", str(paths[0]), "--current", str(paths[1]), *flags]
    rc = bench_regression.main(argv)
    out = capsys.readouterr().out
    jrc = jbench_regression.main(argv)
    assert (rc, out) == (jrc, capsys.readouterr().out)
    assert rc == (0 if case in ("narrowed_cells", "improved_cell", "zero_baseline") else 1)


def _fake_ips(variant: str, mode: str, bs: int) -> float:
    return round(1000.0 / (1 + "nsmblx".index(variant[-1])) / {"infer": 1, "nms": 1.25, "train": 4}[mode]
                 + bs / 7, 4)


def _fake_bench_variant(variant, imgsz=640, batch_sizes=(32,), decode="topk", **_):
    per = {bs: _fake_ips(variant, "nms" if decode == "nms" else "infer", bs) for bs in batch_sizes}
    best = max(per, key=per.get)
    return {"best_ips": per[best], "best_bs": best, "per_bs": per}


def _fake_bench_train(variant, imgsz=640, batch_sizes=(32,), **_):
    per = {bs: _fake_ips(variant, "train", bs) for bs in batch_sizes}
    best = max(per, key=per.get)
    return {"best_ips": per[best], "best_bs": best, "per_bs": per}


def _split(out: str):
    lines = out.splitlines()
    return ([json.loads(x) for x in lines if x.startswith("{")], [x for x in lines if x.startswith("|")])


@pytest.mark.parametrize("in_key", [False, True])
def test_bench_matrix_matches_jax(in_key, tmp_path, monkeypatch, capsys):
    import leanyolo_tpu.utils.compile_cache as cc

    monkeypatch.setattr(cc, "enable_persistent_compile_cache", lambda: None)
    monkeypatch.setitem(__import__("sys").modules, "bench", SimpleNamespace(bench_variant=_fake_bench_variant))
    monkeypatch.setitem(__import__("sys").modules, "bench_train", SimpleNamespace(bench_train=_fake_bench_train))
    monkeypatch.setattr(bench_matrix, "bench_variant", _fake_bench_variant)
    monkeypatch.setattr(bench_matrix, "bench_train", _fake_bench_train)
    flags = ["--variants", "yolov10n,yolov10x", "--modes", "infer,nms,train", "--batch-sizes", "8,16",
             "--imgsz", "320", *(["--imgsz-in-key"] if in_key else [])]
    bench_matrix.main([*flags, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    lines, table = _split(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["bench_matrix.py", *flags, "--out", str(tmp_path / "jax.json")])
    jbench_matrix.main()
    jlines, jtable = _split(capsys.readouterr().out)
    assert table == jtable and len(table) == 4
    assert [{k: v for k, v in x.items() if k != "device"} for x in lines] == jlines
    assert all(x["device"] == "cpu" for x in lines)
    port, jax = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert {k: v for k, v in port.items() if k not in ("device", "card")} == jax
    assert (port["device"], port["card"]) == ("cpu", None)
    assert all(("@320/" in k) == in_key for k in port["cells"])
    for compare in (bench_regression.compare, jbench_regression.compare):
        for a, b in ((port, jax), (jax, port)):
            rows, failures = compare(a, b, 0.05)
            assert not failures and len(rows) == 6 and {r["ratio"] for r in rows} == {1.0}


@pytest.mark.parametrize("mode", ["infer", "nms", "train"])
def test_bench_matrix_raises_on_an_empty_cell(mode, monkeypatch):
    empty = lambda *a, **k: {"best_ips": 0.0, "best_bs": 0, "per_bs": {}}  # noqa: E731
    monkeypatch.setattr(bench_matrix, "bench_variant", empty)
    monkeypatch.setattr(bench_matrix, "bench_train", empty)
    with pytest.raises(RuntimeError, match=f"yolov10n/{mode}: no batch size"):
        bench_matrix.main(["--variants", "yolov10n", "--modes", mode, "--device", "cpu"])


def test_bench_matrix_runs_on_the_cpu(tmp_path, capsys):
    """A real run: yolov10n at 64 px, batch 2, every mode; the file compares
    against itself in both packages."""
    out = tmp_path / "m.json"
    bench_matrix.main(["--variants", "yolov10n", "--modes", "infer,nms,train", "--imgsz", "64", "--batch-sizes",
                       "2", "--chain", "2", "--steps", "1", "--device", "cpu", "--out", str(out)])
    lines, table = _split(capsys.readouterr().out)
    assert [x["metric"] for x in lines] == [f"yolov10n_64_bf16_{m}_images_per_sec_per_chip"
                                            for m in ("infer", "nms", "train")]
    data = json.loads(out.read_text())
    assert set(data) == {"imgsz", "cells", "device", "card"} and set(data["cells"]) == {
        "yolov10n/infer", "yolov10n/nms", "yolov10n/train"}
    for cell in data["cells"].values():
        assert cell["batch_size"] == 2 and cell["images_per_sec_per_chip"] > 0 and list(cell["per_bs"]) == ["2"]
    argv = ["--baseline", str(out), "--current", str(out)]
    assert bench_regression.main(argv) == jbench_regression.main(argv) == 0


def test_synthetic_batch_is_bench_trains_draw():
    """bench_train.py:38-47, spelled in numpy."""
    bs, imgsz, nboxes = 3, 96, 5
    rng = np.random.RandomState(0)
    x1, y1 = rng.uniform(0, imgsz - 60, (2, bs, nboxes)).astype(np.float32)
    wh = rng.uniform(8, 60, (2, bs, nboxes)).astype(np.float32)
    images = rng.randint(0, 256, (bs, imgsz, imgsz, 3)).astype(np.uint8)
    gl = rng.randint(0, 80, (bs, nboxes)).astype(np.int32)
    gb = np.stack([x1, y1, x1 + wh[0], y1 + wh[1]], axis=-1)
    gm = rng.uniform(size=(bs, nboxes)) < 0.4
    got = bench_train.synthetic_batch(bs, imgsz, nboxes)
    for g, r in zip(got, (images, gl, gb, gm)):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("walls", [{64: 0.5, 256: 1.7}, {2: 0.010, 6: 0.026}, {64: 0.9, 128: 1.1, 256: 1.3}])
def test_latency_fit_is_jax_formula(walls, monkeypatch):
    """bench_latency over injected chain walls equals bench.py:172-175."""
    n1, n2 = min(walls), max(walls)
    step_ms = (walls[n2] - walls[n1]) / (n2 - n1) * 1e3
    want = {"step_ms": step_ms, "per_call_overhead_ms": walls[n1] * 1e3 - n1 * step_ms,
            "wall_ms_per_step": {str(n): walls[n] / n * 1e3 for n in walls}}
    timed = iter(x for n in walls for x in (0.0, walls[n]))  # a warm-up chain, then the timed one
    monkeypatch.setattr(bench, "build_model", lambda variant: None)
    monkeypatch.setattr(bench, "serving_predictor", lambda *a, **k: SimpleNamespace(run_batch=lambda x: None))
    monkeypatch.setattr(bench, "chain_s", lambda fn, n, device: next(timed))
    assert bench.bench_latency("yolov10n", 64, tuple(walls), device="cpu") == want
    assert bench.latency_fit(walls) == want


class _Fails:
    """Raises `error` on batches of `at` rows; records the sizes it saw."""

    def __init__(self, error, at: int):
        self.error, self.at, self.seen = error, at, []

    def __call__(self, rows: int):
        self.seen.append(rows)
        if rows == self.at:
            raise self.error("out of memory" if self.error is torch.OutOfMemoryError else "a real fault")


def _run_sweep(which: str, fails: _Fails, monkeypatch):
    monkeypatch.setattr(bench, "build_model", lambda variant: torch.nn.Linear(1, 1))
    if which == "bench_variant":
        def run_batch(x):
            fails(x.shape[0])
            return torch.zeros(x.shape[0], 300, 6), None

        monkeypatch.setattr(bench, "serving_predictor", lambda *a, **k: SimpleNamespace(run_batch=run_batch))
        return bench.bench_variant("yolov10n", 32, (2, 4, 8), chain=2, device="cpu")

    class FakeTrainer:
        def __init__(self, model, cfg, device=None):
            assert (cfg.bf16, cfg.augment, cfg.grad_clip, cfg.steps_per_epoch) == (True, True, 1.0, 1000)

        def train_step(self, batch, gen):
            fails(batch.images.shape[0])
            return {"total": torch.ones(())}

    import leanyolo_tpu_torch.engine.trainer as trainer

    monkeypatch.setattr(bench_train, "build_model", lambda variant: torch.nn.Linear(1, 1))
    monkeypatch.setattr(trainer, "Trainer", FakeTrainer)
    return bench_train.bench_train("yolov10n", 64, (2, 4, 8), nboxes=3, steps=2, device="cpu")


@pytest.mark.parametrize("which", ["bench_variant", "bench_train"])
def test_out_of_memory_ends_the_sweep(which, monkeypatch):
    fails = _Fails(torch.OutOfMemoryError, 4)
    r = _run_sweep(which, fails, monkeypatch)
    assert list(r["per_bs"]) == [2] and r["best_bs"] == 2 and r["best_ips"] > 0
    assert 8 not in fails.seen and fails.seen[-1] == 4


@pytest.mark.parametrize("which", ["bench_variant", "bench_train"])
def test_other_errors_propagate(which, monkeypatch):
    fails = _Fails(ValueError, 4)
    with pytest.raises(ValueError, match="a real fault"):
        _run_sweep(which, fails, monkeypatch)


@pytest.mark.parametrize("entry", ["bench", "bench_latency", "bench_train", "bench_matrix"])
def test_no_card_raises_on_the_default_device(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = {"bench": (bench.main, []), "bench_latency": (bench.main, ["--latency"]),
                  "bench_train": (bench_train.main, []), "bench_matrix": (bench_matrix.main, [])}[entry]
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(argv)


@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_serving_call_is_the_folded_bf16_predictor(decode):
    """The timed call: the folded bf16 predictor with the JAX bench's decode
    constants; its detections are those of a predictor built so, on the
    bench's batch."""
    model = bench.build_model("yolov10n")
    pred = bench.serving_predictor(model, 64, decode, "cpu")
    assert (pred._fuse, pred.dtype, pred.max_det, pred.decode) == (True, torch.bfloat16, 300, decode)
    if decode == "nms":
        assert (pred.conf_thresh, pred.iou_thresh, pred.class_wise_nms) == (0.25, 0.45, True)
    kw = dict(conf_thresh=0.25, iou_thresh=0.45, class_wise_nms=True) if decode == "nms" else {}
    ref = Predictor(model, imgsz=64, decode=decode, max_det=300, dtype="bfloat16", fuse=True, device="cpu", **kw)
    x = bench.make_batch(2, 64, 1, "cpu")
    np.testing.assert_array_equal(x.numpy(), np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3), np.uint8))
    for got, want in zip(pred.run_batch(x), ref.run_batch(x)):
        assert torch.equal(got, want)
    r = bench.bench_variant("yolov10n", 64, (2,), chain=2, decode=decode, device="cpu")
    assert list(r["per_bs"]) == [2] and r["best_ips"] > 0


def test_chain_s_waits_for_every_call():
    calls = []
    assert profiling.chain_s(lambda: calls.append(1), 5, "cpu") >= 0 and len(calls) == 5
    assert profiling.wall_ms(lambda: calls.append(1), runs=4, device="cpu") >= 0 and len(calls) == 5 + 3 + 4


@pytest.mark.parametrize("module", ["tools/bench.py", "tools/bench_train.py", "tools/bench_matrix.py",
                                    "tools/bench_regression.py", "utils/profiling.py"])
def test_new_modules_import_no_jax(module):
    tree = ast.parse((REPO / "leanyolo_tpu_torch" / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "leanyolo_tpu", "experiments", "tools", "bench", "bench_train"}
