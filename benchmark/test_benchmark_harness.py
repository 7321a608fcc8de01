"""CPU tests of the benchmark: its imports, its files found by name, the
counts, the traffic draw, the reference against the system at a small
size, the spans' wrapping, a dry run of each cell and the faults that its
check must catch.

    python -m pytest benchmark -q

Tests that need the card carry the `cuda` marker and skip here.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import generate as G
from benchmark import run, serve, spec, train
from benchmark.counts import bounds as B
from benchmark.counts import flops as F
from benchmark.reference.model import num_params

ROOT = Path(__file__).resolve().parents[1]
SERVE, TRAIN = "yolov10s-serve-b32", "yolov10x-train-b64"
SMALL = ["--device", "cpu", "--imgsz", "128", "--pool", "2", "--dtype", "float32"]
SERVE_SMALL = SMALL + ["--batch", "4"]
TRAIN_SMALL = SMALL + ["--batch", "8"]


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


HELD = ROOT / "benchmark" / "held" / f"{TRAIN}.json"  # the training cell's entries, held out of BENCHMARK.json


@pytest.fixture
def held(tmp_path, monkeypatch) -> Path:
    """A checkout whose BENCHMARK.json also holds the training cell's
    entries (held out of the repo's until its fault is mended); the
    harness's `load_cell` reads it there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    entries = json.loads(HELD.read_text())
    bench = {k: v + entries.get(k, []) if k in entries else v for k, v in _bench().items()}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    load = spec.load_cell
    monkeypatch.setattr(spec, "load_cell", lambda name, root=tmp_path: load(name, root))
    return tmp_path


def _cfg(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _modules_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after `code`."""
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


# -- imports -----------------------------------------------------------------


def test_harness_imports_no_jax():
    code = ("import benchmark.run, benchmark.serve, benchmark.train, benchmark.limits\n"
            "import leanyolo_tpu_torch.engine.predictor, leanyolo_tpu_torch.engine.trainer\n"
            "import leanyolo_tpu_torch.models.registry\n"
            "from benchmark import spec\n"
            "[spec.reader(m['name']) for m in json.load(open('BENCHMARK.json'))['per_layer']]\n")
    found = _modules_after("import json\n" + code)
    assert not found & set(run.FORBIDDEN), found & set(run.FORBIDDEN)
    assert "leanyolo_tpu_torch" in found  # the system is what the harness drives


def test_reference_imports_nothing_of_the_system():
    found = _modules_after("import benchmark.reference.model, benchmark.reference.train, benchmark.counts.flops\n"
                           "import benchmark.counts.bounds, benchmark.generate\n")
    assert not found & {"leanyolo_tpu_torch", "leanyolo_tpu", "jax", "jaxlib", "flax", "experiments"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "leanyolo_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "leanyolo_tpu_torch.probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "leanyolo_tpu.probe", object())
    assert run.forbidden_modules() == ["leanyolo_tpu"]


# -- files found by name ---------------------------------------------------------


def test_every_cell_and_metric_found_by_name(held):
    bench = json.loads((held / "BENCHMARK.json").read_text())  # the repo's cells and the held one
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        assert set(cell.limits) >= {"failed_requests"} or set(cell.limits) >= {"failed_steps"}
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a cell (a traffic file, a limits file)
    and a per-layer metric (a reader) with entries in BENCHMARK.json only,
    and runs the new cell without an edit to any file that was there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    mix = json.loads((ROOT / "benchmark" / "traffic" / "serve-b32-closed2.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "serve-b8-closed1.json").write_text(json.dumps({**mix, "batch": 8, "in_flight": 1}))
    limits = json.loads((ROOT / "benchmark" / "workloads" / f"{SERVE}.json").read_text())
    (tmp_path / "benchmark" / "workloads" / "yolov10s-serve-b8.json").write_text(json.dumps(limits))
    (tmp_path / "benchmark" / "metrics" / "requests_traced.py").write_text(
        "def read(r):\n    return float(r.trace.units) if r.kind == 'serve' else None\n")
    bench["workloads"].append({"name": "yolov10s-serve-b8", "config": "yolov10s-640", "traffic": "serve-b8-closed1",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and SERVE in m["workloads"]:
            m["workloads"].append("yolov10s-serve-b8")
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "entry, serving (engine/predictor.py)",
                               "moves": "serve_img_per_s", "workloads": ["yolov10s-serve-b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    probe = subprocess.run([sys.executable, "-c", "from benchmark import spec; c = spec.load_cell('yolov10s-serve-b8');"
                            "print(sorted(m['name'] for m in c.per_layer), c.traffic['batch'])"],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120, check=True)
    assert "requests_traced" in probe.stdout and probe.stdout.strip().endswith(" 8")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "yolov10s-serve-b8", "--seed", "5",
                          "--seconds", "0.3"] + SERVE_SMALL, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_command_fails_without_the_system(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files, the run exits non-zero."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", SERVE, "--seed", "1", "--seconds", "1"]
                         + SERVE_SMALL, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


# -- counts ----------------------------------------------------------------------


@pytest.mark.parametrize("name,published", [("yolov10s-640", 21.6), ("yolov10x-640", 160.4)])
def test_flop_counter_against_the_published_gflops(name, published):
    cfg = _cfg(name)
    counted = F.forward_flops(cfg, 640, ("one2one",))
    gap = counted["total"] / 1e9 / published - 1
    print(f"{name}: {counted['total'] / 1e9:.4f} GFLOPs counted against {published} published ({gap:+.2%}; "
          f"convs alone {counted['conv'] / 1e9:.4f}, attention {counted['attention'] / 1e9:.4f})")
    assert abs(gap) < 0.01
    params = {"yolov10s-640": 7.2, "yolov10x-640": 29.5}[name]
    assert num_params(cfg) / 1e6 == pytest.approx(params, rel=0.01)  # the deploy model: one2one head, BN folded
    assert F.train_flops(cfg, 640) == 3 * F.forward_flops(cfg, 640, ("one2many", "one2one"))["total"]


def test_byte_counts_hand_worked():
    assert B.bmm_work(1, 2, 3, 4) == (2 * (6 + 12 + 8), 48)
    assert B.bmm_work(2, 5, 7, 3, elt=4) == (4 * (70 + 21 + 30), 420)
    assert B.bn_moments_work(10, 4) == (10 * 4 * 2 + 32, 120)
    assert B.bn_moments_bwd_work(10, 4) == (2 * 10 * 4 * 2 + 32, 120)
    assert B.bound_s(3.35e12, 0.0, B.BF16_OPS_PER_S) == pytest.approx(1.0)
    assert B.bound_s(0.0, 989e12, B.BF16_OPS_PER_S) == pytest.approx(1.0)
    cfg = _cfg("yolov10s-640")
    # the serving path's 45 products at batch 32 and the training BNs: the figures the system's own table gives
    assert B.bmm_bound_s(cfg, 640, 32) * 1e3 == pytest.approx(0.7699, abs=1e-4)
    fwd, bwd, calls = B.bn_moments_bound_s(cfg, 640, 32)
    assert (round(fwd * 1e3, 4), round(bwd * 1e3, 4), calls) == (0.7611, 1.5221, 99)


@pytest.mark.parametrize("name", ["yolov10s-640", "yolov10x-640"])
def test_shapes_match_the_system(name):
    from leanyolo_tpu_torch.kernels import bounds as system_bounds

    cfg = _cfg(name)
    assert B.serving_1x1_shapes(cfg, 640) == system_bounds.serving_1x1_shapes(cfg["model"], 640)
    assert B.train_bn_shapes(cfg, 640, 64) == system_bounds.train_bn_shapes(cfg["model"], 640, 64)


# -- the traffic -----------------------------------------------------------------


def test_coco_like_draw():
    gt = json.loads((ROOT / "benchmark" / "traffic" / "train-b64-coco.json").read_text())["gt"]
    shapes = G.gt_shapes(gt, 20000)
    counts = np.array([len(s) for s in shapes])
    assert counts.mean() == pytest.approx(7.3, rel=0.03) and counts.min() >= 1 and counts.max() <= 64
    side = np.sqrt(np.prod(np.concatenate(shapes), axis=1))
    split = [np.mean(side < 32), np.mean((side >= 32) & (side < 96)), np.mean(side >= 96)]
    print(f"mean count {counts.mean():.3f}; small/medium/large {split}")
    assert split == pytest.approx([0.40, 0.317, 0.283], abs=0.02)


def test_every_seed_asks_for_the_same_work():
    gt = json.loads((ROOT / "benchmark" / "traffic" / "train-b64-coco.json").read_text())["gt"]
    a, b = (G.make_gt(gt, 2, 64, 640, seed, 80) for seed in (1, 2**31 + 17))
    for (la, ba, ma), (lb, bb, mb) in zip(a, b):
        assert sorted(ma.sum(1)) == sorted(mb.sum(1))
        wa, wb = (np.sort((x[..., 2] - x[..., 0])[m]) for x, m in ((ba, ma), (bb, mb)))
        np.testing.assert_allclose(wa, wb, rtol=1e-5)
        assert (ba[ma] >= 0).all() and (ba[ma] <= 640).all()
        assert not np.array_equal(ba, bb)
    picks = []
    for _ in range(2):  # the requests a run checks: k of however many it finishes, the same for the same seed
        res = G.Reservoir(2**31 + 17, 16)
        kept = {}
        for n in range(2000):
            j = res.offer(n)
            if j is not None:
                kept[j] = n
        picks.append(sorted(kept.values()))
    assert picks[0] == picks[1] and len(picks[0]) == 16 and max(picks[0]) > 1000


# -- the reference against the system ----------------------------------------------


def _small_state(name: str, seed: int, size: int = 128, n: int = 4):
    cfg = _cfg(name)
    state = G.make_state(cfg, seed, "cpu")
    images = G.make_images(n, size, {"coarse": 8, "noise_std": 12}, G.generator(seed, G.STREAM_IMAGES, "cpu"), "cpu")
    G.calibrate_state(cfg, state, images)
    return cfg, state, images


def _predictor(cfg, state, dtype="float32"):
    from leanyolo_tpu_torch.engine.predictor import Predictor
    from leanyolo_tpu_torch.models.registry import get_model

    model = get_model(cfg["model"], weights=None, class_names=[str(i) for i in range(cfg["nc"])])
    model.load_state_dict(state)
    return Predictor(model, imgsz=128, decode="topk", dtype=dtype, fuse=True, device="cpu")


def test_reference_serves_as_the_system_does():
    cfg, state, images = _small_state("yolov10s-640", 11)
    pred = _predictor(cfg, state)
    dets, num = pred.run_batch(images)
    logits, boxes, stride = serve.reference_maps(cfg, state, images)
    got = serve.compare(dets.numpy(), num.numpy(), logits, boxes, stride, conf=cfg["serve"]["conf_thresh"])
    assert got["logit_rms"] < 1e-3 and got["box_gap_p90"] < 1e-3 and got["num_mismatch"] == 0
    assert got["det_unmatched"] == 0


def test_reference_trains_as_the_system_does(held):
    cell = spec.load_cell(TRAIN)
    cfg = {**cell.config, "train": {**cell.config["train"], "dtype": "float32"}}
    mix = {**cell.traffic, "imgsz": 128, "batch": 2, "pool": 2, "setup_steps": 1}
    tr, pool, state, got, gen = train.setup(cfg, mix, 7, torch.device("cpu"))
    train.window(tr, pool, gen, 1, 0.0, max_steps=1, check=(got, state))  # the window's first step is checked too
    ref = train.reference_readings(cfg, mix, state, pool, 7, 2)
    found = train.compare(got, ref, cfg["train"]["bn_momentum"])
    assert found["loss_gap"] < 1e-4 and found["grad_median"] < 1e-3 and found["bn_var_median"] < 1e-3
    # two AdamW steps: a rounding-level gradient gap becomes a full-size update (0.003 here)
    assert found["change_gap"] < 1e-2 and len(got.losses) == 2


def test_wrapped_spans_leave_the_timed_entries_unchanged(held):
    cfg, state, images = _small_state("yolov10s-640", 12)
    pred = _predictor(cfg, state)
    dets, num = pred.run_batch(images)
    d2, n2 = pred.decode_raw(pred.raw(images))
    serve.wrap_spans(pred)
    d3, n3 = pred.run_batch(images)
    for a, b in ((dets, d2), (dets, d3), (num, n2), (num, n3)):
        assert torch.equal(a, b)

    cell = spec.load_cell(TRAIN)
    cfg = {**cell.config, "train": {**cell.config["train"], "dtype": "float32"}}
    mix = {**cell.traffic, "imgsz": 128, "batch": 2, "pool": 2, "setup_steps": 1}
    runs = []
    for wrapped in (False, True):
        tr, pool, _, _, gen = train.setup(cfg, mix, 8, torch.device("cpu"))
        if wrapped:
            train.wrap_spans(tr)
        loss = float(tr.train_step(pool[1], gen)["total"])
        runs.append((loss, [p.detach().clone() for p in tr.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# -- dry runs and the faults their check catches ----------------------------------------


def _dry(workload: str, extra, seconds: str = "0.3", root: Path = ROOT) -> dict:
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(2**31 + 5),
                          "--seconds", seconds] + extra, cwd=root, capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,extra", [(SERVE, SERVE_SMALL), (TRAIN, TRAIN_SMALL)])
def test_dry_run_prints_a_well_formed_last_line(workload, extra, held):
    r = _dry(workload, extra, root=held)
    assert list(r)[-1] == "checks" and {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = spec.load_cell(workload)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 and m["unit"] for m in r["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


def _stale(pred):
    """A request that returns the previous request's detections."""
    fn, last = pred.run_batch, []

    def run_batch(images):
        out = fn(images)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    pred.run_batch = run_batch


def _half_batch(pred):
    """Half of each batch left out: its images come back with no detection."""
    fn = pred.run_batch

    def run_batch(images):
        h = images.shape[0] // 2
        dets, num = fn(images[:h])
        return torch.cat([dets, torch.zeros_like(dets)]), torch.cat([num, torch.zeros_like(num)])

    pred.run_batch = run_batch


def _score_twice(pred):
    """Every detection's score squashed twice where the decode writes it (sigmoid of the sigmoid)."""
    fn = pred.decode_raw

    def decode_raw(raw):
        dets, num = fn(raw)
        return torch.cat([dets[..., :4], torch.sigmoid(dets[..., 4:5]), dets[..., 5:]], -1), num

    pred.decode_raw = decode_raw


def _class_next(pred):
    """Every detection's class one off where the decode writes it."""
    fn = pred.decode_raw

    def decode_raw(raw):
        dets, num = fn(raw)
        return torch.cat([dets[..., :5], (dets[..., 5:] + 1) % pred.model.nc], -1), num

    pred.decode_raw = decode_raw


def _box_next_rank(pred):
    """Every detection given the box of the next-ranked one: right scores and classes on another anchor's box."""
    fn = pred.decode_raw

    def decode_raw(raw):
        dets, num = fn(raw)
        return torch.cat([dets[..., :4].roll(-1, dims=1), dets[..., 4:]], -1), num

    pred.decode_raw = decode_raw


@pytest.mark.parametrize("breaker", [_stale, _half_batch, _score_twice, _class_next, _box_next_rank])
def test_serving_check_catches_a_broken_timed_path(breaker, capsys):
    """At 256 px. A stale answer reads 2.44-6.91 in logit_rms at the cell's own size (12 of 12 seeds, the
    limits' readings); at small sizes random images' best logits are alike and it depends on the seed."""
    small = [a if a != "128" else "256" for a in SERVE_SMALL]
    r = run.main(["--workload", SERVE, "--seed", "9", "--seconds", "0.5"] + small, breaker=breaker)
    assert r["correct"] is False, r["checks"]


def _unchanged_state(tr):
    tr.optimizer_step = lambda: None


def _half_batch_step(tr):
    """The loss of the first half of each batch alone, its mean over the rest."""
    fn = tr.forward_backward

    def forward_backward(batch, generator=None):
        h = batch.images.shape[0] // 2
        from types import SimpleNamespace

        half = SimpleNamespace(images=batch.images[:h], gt_labels=batch.gt_labels[:h], gt_boxes=batch.gt_boxes[:h],
                               gt_mask=batch.gt_mask[:h])
        torch.rand(h, generator=generator)  # the other half's draws, so the augmentation stays in step
        return fn(half, generator)

    tr.forward_backward = forward_backward


@pytest.mark.parametrize("breaker", [_unchanged_state, _half_batch_step])
def test_training_check_catches_a_broken_timed_path(breaker, capsys, held):
    r = run.main(["--workload", TRAIN, "--seed", "9", "--seconds", "0.5"] + TRAIN_SMALL, breaker=breaker)
    assert r["correct"] is False, r["checks"]


# -- the control -----------------------------------------------------------------


def test_serving_control_fails_its_check():
    cfg, state, images = _small_state("yolov10s-640", 13, n=8)
    limits = spec.load_cell(SERVE).limits
    got = serve.control(cfg, state, images.view(2, 4, *images.shape[1:]))
    assert any(got[k] > limits[k] for k in serve.COMPARED), got


def test_training_control_fails_its_check(held):
    cell = spec.load_cell(TRAIN)
    cfg, mix = cell.config, {**cell.traffic, "imgsz": 128, "batch": 8, "pool": 2}
    state = G.make_state(cfg, 14, "cpu")
    pool = G.train_pool(mix, cfg, 14, "cpu")
    steps = int(mix["setup_steps"]) + 1  # set-up's steps and the window's first
    ref = train.reference_readings(cfg, mix, state, pool, 14, steps)
    low = train.reference_readings(cfg, mix, state, pool, 14, steps, quant="fp8")
    got = train.compare(low, ref, cfg["train"]["bn_momentum"])
    assert any(got[k] > cell.limits[k] for k in train.COMPARED), got


@pytest.mark.cuda
def test_controls_fail_at_the_cells_own_size(held):
    """On the card, at each cell's own size: the control on one seed fails
    its cell's check (the limits' readings: python -m benchmark.limits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for workload in (SERVE, TRAIN):
        out = subprocess.run([sys.executable, "-m", "benchmark.limits", "--workload", workload, "--seeds", "",
                              "--control-seeds", "20251"], cwd=held, capture_output=True, text=True, timeout=1200,
                             env={**os.environ, "PYTHONPATH": str(ROOT)})
        assert out.returncode == 0, out.stderr[-3000:]
        limits = spec.load_cell(workload).limits
        compared = serve.COMPARED if workload == SERVE else train.COMPARED
        for line in out.stdout.strip().splitlines():
            r = json.loads(line)
            if r["kind"] == "control_fp8":
                assert any(r[k] > limits[k] for k in compared), r


def test_readers_on_a_synthetic_trace(held):
    """Every per-layer reader of each cell on a made-up trace: a number where its kernels and spans are
    there, nothing where they are not (bmm's roofline with no `gemm_kernel` launch)."""
    from benchmark.timing import Kernel, Trace

    ms = 1_000_000
    spans = {"forward": [(0, 8 * ms)], "decode": [(8 * ms, 9 * ms)], "request": [(0, 10 * ms)],
             "forward_backward": [(0, 8 * ms)], "optimizer_step": [(8 * ms, 9 * ms)], "step": [(0, 10 * ms)]}
    kernels = [Kernel("elementwise_kernel", 1 * ms, 6 * ms, 1 * ms), Kernel("topk_kernel", 9 * ms, 10 * ms, 8 * ms + 1)]
    trace = Trace(kernels, [], spans, (0, 12 * ms), units=1, extra={"dropped": 0})
    for workload, kind in ((SERVE, "serve"), (TRAIN, "train")):
        cell = spec.load_cell(workload)
        r = run.LayerReadings(kind, trace, 12.5, {"serve_img_per_s": 2500.0}, cell.config, 640, 32)
        got = spec.read_all(cell.per_layer, r)
        assert "bmm_roofline" not in got and "bn_moments_roofline" not in got
        for name, m in got.items():
            assert math.isfinite(m["value"]) and m["value"] >= 0, (name, m)
        assert got[f"device_idle_pct.{kind}"]["value"] == pytest.approx(100 * (1 - 6 / 12))
        if kind == "serve":
            assert got["forward_device_ms"]["value"] == pytest.approx(5.0)
            assert got["serve_host_ms"]["value"] == 12.5
        else:
            assert got["fwd_bwd_device_ms"]["value"] == pytest.approx(5.0)
