#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (leanyolo_tpu_torch) on one NVIDIA card.

Phases, each of which fails loudly (non-zero exit):

1. the card's name and power limit (nvidia-smi);
2. build the kernels from leanyolo_tpu_torch/kernels/csrc (build/kernels/);
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving path (yolov10s, 640 px, batch 32): the stem also at
   ragged maps; dw7x7 also at a map split into bands and at an odd C; top-k
   bit-equal at k in {1, 300, 1000, 1024, 1025, 1500, n} on both decode shapes,
   bf16 and fp32, both signed-zero rules, and decode_topk(max_det=1500) at
   320 px; mpbwd bit-equal on both of its routes (16-byte and general);
   s2dconv and bmm on the very inputs of one batch-32 forward (the stage-1
   bottleneck's two 3x3 convs, the 45 dense 1x1 convs with their bias and
   SiLU), in bf16 and fp32, plus an odd shape each; bmm's fused epilogue
   against the bias-free kernel followed by PyTorch's bias add and SiLU (at
   most one bf16 ulp apart); the top-k decode's fused second top-k
   (topk_decode: the level gather K2 as its key builder, the box decode K3
   as its epilogue) and the box decode (K3, dfl_boxes, NMS mode) bit-equal
   to their plain versions at the decodes' shapes (DECODE_SHAPES: [32, 300]
   and [32, 1000] at 640 px, [8, 1500] at 320, batch 1, k = A, odd class
   counts), bf16 and fp32, on whole maps and on the strided slices of a
   concatenated map, with signed zeros, the fused op at k = 300, 1 and past
   the rank-counting route, on the maps' non-finite flags; the
   flagging max/argmax (K4 with the flags), the fused op and K3 with flags
   bit-equal to their plain versions on batch-32 maps holding +inf, -inf,
   NaN (and two +inf in a column, a side of 16 -inf bins) in image 1; the training BN's batch moments
   (K8, bn_moments and bn_moments_bwd) bit-equal to their plain versions,
   each launched three times with the same bits, at the 14 input shapes of
   the 99 BNs of a batch-32 yolov10s 640 training forward in bf16, three
   of them in fp32, at odd shapes (C = 33 on the general route, one row,
   row counts that leave the last block partial, C = 8) in both, on a
   contiguous NCHW input and on a cancellation case (mean 1000, std 0.01
   in fp32, where the variance clamps), and an empty input (zero sums, no
   launch); the task-aligned assignment's two kernels (K6 + K7,
   tal_candidates and tal_targets) bit-equal to its plain version on the
   five outputs and, in its check mode, on every row's CIoU and alignment,
   at k = 10 and 1, at each case of tests/tal_cases.py (a padded slot that
   wins the highest-CIoU resolve, the anchor-0 fallback, zero-align
   members, identical boxes, k >= A, 1, 16 and 128 slots, the concatenated
   head's strided scores, an all-padded image, 640 px, 1536 px with ties
   and a NaN logit on both sides of the candidates kernel's first pass,
   2560 px in three passes) and at the training step's [32, 16, 8400] with
   80 classes, and a batch against its halves;
4. the serving path: yolov10s at full width and depth, random weights from a
   seed, folded to bf16, answers uint8 requests of batch 1, 8 and 32 through
   Predictor.run_batch; the launches of every kernel are counted per request
   (stem 1, dw7x7 2, s2dconv 2, bmm 45, argmax 1, top-k 2 (stage 1 and the
   fused second top-k), dfl_boxes 0, all 45 bmm on bmm's TMA + wgmma route, the stem on its
   tensor-core route and both s2dconv launches on its wgmma route). Then
   the kernel path is held against the all-plain path on the card, the
   top-k decode on identical bf16 and fp32 head maps bit-equal to the
   all-plain decode at batch 1, 8 and 32, and an fp32 run on the card
   against an fp32 run on the CPU at a small input;
5. times from CUDA events (warm-up, median of 20 runs): each kernel, its
   plain version and the PyTorch call that computes the same function, each
   run the mean of 10 back-to-back calls (bmm also per distinct shape, with
   its route and tile; the fused second top-k on the top-k decode's own
   inputs of a batch-32 request, with its host time a call), and the
   serving path's images per second at batch 32, each run one request from
   an idle card; a profile of the serving step with its count of
   elementwise kernels;
6. the NMS decode: the fused max/argmax (K4) bit-equal to its plain
   version on bf16 and fp32 levels with signed-zero ties and repeated
   maxima under both zero rules, the NMS (K5) bit-equal at n in {1, 63,
   1000, 1500} and 1, 8, 32, 66 and 140 images a launch, and at n =
   10,000 and 12,000, with valid masks, IoUs exactly at the threshold,
   class-wise on and off, max_det below the survivors, and at n = 2^21 on
   a known answer; then Predictor(decode="nms") on yolov10s (bf16, folded)
   answers requests of batch 1, 8 and 32 at the inference defaults (conf
   0.25, IoU 0.45) and the validator's (0.001, 0.65: 1000 valid
   candidates), and one class-wise, with its launches counted per request
   (stem 1, dw7x7 2, s2dconv 2, bmm 45, argmax 1, top-k 1, dfl_boxes 1,
   nms 1); the
   decode on identical head maps bit-equal to the all-plain decode at
   batch 1, 8 and 32 (one batch-32 forward a predictor, its first images
   for the smaller batches; bf16 maps at each setting, fp32 maps at the
   inference defaults); fp32 on the card against the CPU at 128 px; K5
   bit-equal on the path's batch-32 candidates; K4, K3 (NMS mode, [32,
   1000]) and K5 timed at the path's shapes (K5 at batch 32 and 1, with its
   host cost a call and the
   IoU pairs it evaluates beside those the data needs, and the split of
   the kernel it replaced) and the NMS request at batch 32 and 1, with a
   profile;
   predict_images on eight images of mixed sizes (1080x1920 among them),
   host and device letterbox, both decodes, every box inside its image,
   host and device letterbox held together as the JAX package holds them;
7. every size, yolov10n/s/m/b/l/x at full width and depth, folded in bf16
   and in fp32, serves a batch of 2 at 640 px through Predictor.run_batch
   with the stem on the kernel route of its dtype, held against the
   all-plain path as in 4; the stem of each size is timed at
   [32,640,640,3] uint8 against cuDNN and its bound (with the kernel
   records its device-time profile kept);
8. the training path: yolov10s at full width and depth, 640 px, bf16
   activations over fp32 parameters, trains through Trainer.train_step at
   batch 32 (24 GT slots, 40% valid, augmentation on, clip 1.0): 3 warm-up
   and 10 timed steps, with the launches of the SPPF max-pool backward
   kernel (3 a step), of K8 (bn_moments and bn_moments_bwd 99 a step
   each, all on the 16-byte route) and of the assignment (tal_candidates
   and tal_targets 2 a step each) counted over them, finite losses, peak
   memory and a profile; the assignment on one step's own inputs (k = 10
   and 1) bit-equal to its plain version; the loss on one fixed batch falls
   over 20 steps;
   one fp32 step with the kernels against the all-plain step from the same
   state (deterministic cuDNN), and one fp32 step on the card against the
   CPU (yolov10n, 128 px); then mpbwd and K8 timed (K8 summed over the
   step's 99 BN inputs, with torch.batch_norm_stats as the forward's library
   call and torch.addcmul as the backward's; its device time from profiles
   whose kernel records are matched to their launches' shapes); the
   assignment's two kernels timed each alone on that step's own inputs,
   summed over its two calls, beside the plain version's matching pass and
   the bound of the data's valid slots (no library call computes it);
9. official weights (run after 6): the yolov10s of 4 written as a THU-MIG
   release file (`model.{idx}.` keys, fp16, a pickled DetectionModel whose
   module cannot be imported, so the reader must stub it), once unfused and
   once with the fused-RepVGGDW spelling; get_model(weights=
   "PRETRAINED_COCO") finds each through LEANYOLO_WEIGHTS_DIR and must load
   it at full coverage, with no random-init fallback and no missing leaf;
   the unfused file's model serves a batch-32 request (bf16, folded, top-k;
   launches counted) with head maps and detections bit-equal to the source
   module's after the same fp16 rounding; the fused file's fp32 head maps
   stay within 1e-3 of scale of the source module folded with the merged
   RepVGGDW kernels and biases rounded as the file rounds them; a .npz save_checkpoint/get_model round trip is bit-equal;
   the load's wall time and the request's time are printed;
10. COCO validation (run after 9): 64 JPEG images of noise and filled
   rectangles at COCO-like sizes and one small size (some labels under
   32^2 px) and 80 COCO categories are written, and labelled by the fp32
   folded predictor's own detections (predict_images, host letterbox; see
   self_label); the model (make_model's, calibrated
   again on these images) goes through save_checkpoint and get_model as a
   user loads one; validate_coco at batch 32 in fp32 (top-k, host
   letterbox: mAP at least 0.99 on its own labels) and bf16 folded, the
   main path (top-k with host and with device letterbox, whose mAPs agree
   within 2e-2; NMS at the validator's thresholds), and the bf16 top-k
   run again with every kernel swapped for its plain version, whose mAP
   the kernel run's may be no further from than it is from fp32's. Each
   run scores 64
   images, launches the path's kernels per batch, saves detections
   bit-equal to run_batch's (run_canvas's) on the same batches, and
   re-scored in a fresh evaluator they give the same stats. With viz_dir
   (host letterbox named by file, device letterbox by id) it draws one image
   an image, at the letterbox's or the original's size, its stats unchanged.
   Printed: each
   run's stats, wall time and images per second, the host's and the
   device's share of a run (the evaluator with and without the crowd
   regions), measure_fps at batch 1, and the validation CLI
   driven once in a subprocess (mAP line, a 27-column CSV row, 16 images
   drawn by --viz-dir, the row's viz_dir column);
11. training from a folder: a COCO-format set of shapes of fixed class on
   noise (64 train and 32 val JPEGs at COCO-like sizes) feeds
   DataLoader(shuffle=True) and Trainer (yolov10s 640 bf16, batch 32,
   augment, clip 1.0) with the host and with the device letterbox: finite
   losses, mpbwd 3 launches a step, K8 99 + 99 and the assignment 2 + 2, ms a step (also in turns, host,
   device, device, host) and peak memory for each; the
   CLIs' validation (fp32 unfolded top-k) launches top-k; remat="full"
   against "none" on one fp32 step from one state (deterministic cuDNN:
   gradients and parameters within 1e-5 of scale, BN statistics advanced
   once and equal; K8's launches a step 99 + 99, and 198 + 99 with remat,
   whose recompute runs every BN's forward again; the assignment's 2 + 2
   either way) and the peak memory and step time of both in bf16 at
   batch 32 (full must be lower); then the CLIs in subprocesses, two at a
   time, beside 14's QT-001 training: the train CLI (3
   epochs, bf16, augment, device letterbox: a history row with finite
   losses and mAP each epoch, the last epoch's mean loss below the first's,
   its checkpoints) beside a run of 2 epochs, then that run resumed to 3,
   whose last.npz equals the uninterrupted run's bit for bit (cuDNN and
   PyTorch deterministic), beside the transfer CLI from the train CLI's 3-class ckpt.npz onto 2
   classes (the head leaves skipped, UNFREEZE at epoch 2, a VAL line each
   epoch, best.npz, --viz-interval 2 snapshots named by step), each CLI's
   wall time printed;
12. drawing and export (run last): K5's bf16 arithmetic mode bit-equal
   to its plain version (keep masks at IoU 0.45, 0.451 and 0.65 with valid
   masks, and the compaction, class-wise and not) at 8, 32 and 66 images a
   launch and n in {63, 1000, 1500}, and decode_direct_nms on bf16 maps at
   batch 8 and 32 bit-equal to its plain versions; the host cost of a
   kernel call through its torch.library operator against its CUDA
   implementation called directly and the binding's call alone (dw7x7,
   in turns), with Predictor.run_batch's wall at batch 1 and 32 and the
   operators' share of it; yolov10s 640 bf16 folded serving artifacts of
   both decodes (top-k; class-wise NMS at 0.25 / 0.45) exported with a
   symbolic batch, saved and loaded (each timed), run at batch 1, 8 and 32
   bit-equal to the live build_serving_fn with every kernel's launches
   counted per call (stem 1, dw7x7 2, s2dconv 2, bmm 45 on their bf16
   routes, top-k 1, and argmax 1 or nms 1) and request times against the
   live module and Predictor.run_batch; an fp32 artifact against the CPU
   port's live module at 128 px; a bucketed (320, 640) export serving five
   mixed-size images equal to the live module of each bucket; the inference
   CLI in a subprocess (bf16 NMS, three JPEGs and an unreadable file: its
   box lines equal to predict_images in process, drawn images at their own
   sizes) and update_demo_viz;
13. data parallelism (run last; leanyolo_tpu_torch/parallel/), in ranks this
   script starts as processes of their own (`--rank`, one fresh port each;
   the one-rank and the two-rank job at once, the one rank timing its steps
   once the two ranks have ended; any rank's failure or a timeout fails the
   run): the card count and NCCL's
   version; one NCCL rank: Trainer(mesh=make_mesh()) on yolov10s 640 at
   batch 32 (augment, clip 1.0) bit-equal to the plain Trainer in one fp32
   and one bf16 step (losses, every gradient, statistic and parameter;
   deterministic cuDNN), mpbwd 3 and the assignment 2 + 2 launches a step, both bf16 steps timed in
   turns (median of 6 after 3 warm-ups) and the mesh step's collectives
   from the profiler; two ranks of 16 rows (NCCL on two cards, or gloo on
   the one card: printed): the fp32 step against the one-process step on
   the global batch, loss within 1e-5 relative and statistics within 1e-5;
   its gradients are printed with the SPPF max-pool windows whose argmax
   moved (a window routes its gradient to its argmax, and a change in the
   last bits of the pools' input moves a near-tied one), and held with that
   backward swapped for an average pool's in both runs (box_pool_backward):
   each within 1e-4 of its tensor's scale or the one-process step's own
   card-vs-CPU spread (the same draws), whichever is larger, and so their
   relative L2; the bf16 step within bf16's own gap
   from fp32, parameters equal on both ranks, mpbwd 3 and the assignment 2 + 2 a rank, the bf16
   step timed (two ranks on one card are no scaling number), a bf16
   folded Predictor(mesh=) of each decode (top-k; class-wise NMS) with
   every serving kernel launched on each rank and each rank's rows equal to
   its own predictor's; and validate_coco(shard=) of item 10's set (fp32
   top-k, host letterbox) against the one-process run: 64 images, the mAP
   within 1e-3, detections matched within 1e-3 px, the slowest shard's wall.
14. the remaining CLIs and utils (run after 11, before 12), each run as a
   user runs it (`python -m leanyolo_tpu_torch.tools.<name>`):
   profile_step, alone on the card before 11, on the serving step (yolov10s 640 bf16 --fuse, batch 32,
   3 steps) whose table, parsed from torch.profiler's trace, holds each of
   the port's kernels as a family with its launches a step (top-k decode:
   stem 1, dw7x7 2, s2dconv 2, bmm 45, argmax 1, top-k 2; NMS decode:
   argmax 1, top-k 1, dfl_boxes 1, nms 1 and the
   rest) and whose device time a step is within 10% of 5's profile of the
   same step; on the training step (mpbwd 3, bn_moments 99,
   bn_moments_bwd 99, tal_candidates 2 and tal_targets 2 a step), printed beside
   PERF.md's figure; a shortened QT-001 (the JAX package's SQA convergence
   step, 20 of its 30 epochs; its training runs beside 11's CLIs and the
   checks below, and is read last) through the port's CLIs (make_learnable_coco's
   240 images, seed 0, and 60 held out, seed 777; train yolov10n 160 px at
   batch 16, bf16, augment, clip 1.0; val with the top-k decode; the two-arm
   convergence_gate at held-out mAP50 0.2, strict on cuda), with every
   epoch's loss and the CLI's wall time; a release-format yolov10n through
   convert_official_weights --local-pt, served at batch 32 bit-equal to its
   source; check_map_parity on the held-out set self-labelled by it against
   validate_coco in process (PARITY OK) and off by 0.05 (PARITY FAILED, a
   non-zero exit), the two at once; check_imports over the port, and at the
   same time an import of every port module with JAX hidden from the import
   system.
15. spatial and tensor parallelism (run last; parallel/spatial.py and
   parallel/tensor.py): the band plans at 640 px over 2 and 4 ranks; then,
   in this process on the card with the ranks as threads, each mesh's
   split op by op (`split_ops`: each op given the whole run's input rows on
   its band or slice, at yolov10s 640 bf16 folded batch 32): the port's
   kernels and exact ops bit-equal to the whole op, a cuDNN or cuBLAS op
   within one bf16 ulp of its largest output in at most 1e-3 of its
   outputs; and the maps those threads gather. Then jobs of ranks this
   script starts (`--split-rank`; NCCL where there are as many cards, else
   gloo on the one card; the three jobs at once): two ranks on
   make_sp_mesh(1, 2), two on make_tp_mesh(1, 2), four on
   make_sp_mesh(1, 4), each serving the same
   model and batch through Predictor(mesh=) with the top-k and the
   class-wise NMS decode. A rank prints its band plan or split-layer count
   and the layers kept whole, the bytes it received a request (halo and
   gathered rows, or gathered channels), its launches a request (every
   serving kernel, as one process: stem 1, dw7x7 2, s2dconv 2, bmm 45,
   argmax 1, top-k 2, or argmax 1, top-k 1, dfl_boxes 1, nms 1), and wall
   and device ms a request
   (shared-card figures, not scaling; a device time from a profile that
   kept every record). Held: the launches, every rank's detections equal
   and the decode of its gathered maps, those maps bit-equal to the
   threads', each head map's rms gap to the one-process bf16 predictor on
   the card within bf16's own gap (one process bf16 vs fp32) and no gap at
   all where every op matched the whole op; at fp32 and batch 2, head maps
   bit-equal to one process and the top-k (largest class logits) the same
   anchors and classes on every row whose gaps to its neighbours exceed
   the two rows' one-process card-vs-CPU gaps (at least 200 such rows).
   The bf16 top-k's agreement with one process is printed, not held: a
   cuDNN sum rounded the other way moves these random weights' bf16 logits
   by whole units.
16. training past one pass of the candidates kernel (run after 8): one
   yolov10n step at 1536 px, batch 2 (A = 48,384; 3's cases hold the
   kernel at 48,384 and 134,400 anchors): a finite loss, the assignment's
   2 + 2 launches, and the step's two assignments bit-equal to the plain
   version in check mode;
17. the bench CLIs (run after 14's profile_step): bench on yolov10s 640
   top-k at batch 32 with a short chain as a user runs it (`python -m
   leanyolo_tpu_torch.tools.bench`), alone on the card, printed beside 32 /
   5's request time from an idle card; then through their main(argv) in
   this process bench --latency for both decodes, bench_train (yolov10n,
   batch 8, 4 steps) and bench_matrix over yolov10n's infer, nms and train
   cells at batch 8 with --out; bench_regression (`python -m`) of that file
   against itself (exit 0) and against a copy with one cell doubled (exit
   1). Each JSON line names its metric as the JAX bench does, and the card.

Before the card's line at the end, the run prints the seconds it spent on
the decode kernels' (the fused second top-k, K3, K4's flags) checks and
times, those of
the batch moments (K8) and of the assignment (K6, K7), and the run's whole
time. The
second-to-last line is a JSON object with one entry per kernel; the last is
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from leanyolo_tpu_torch.utils.profiling import card_line, events_ms, wall_ms  # noqa: E402  (the port's timers)

# H100 SXM published peaks (NVIDIA data sheet, dense) for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}

IMGSZ = 640
BATCH = 32
MAX_DET = 300
NC = 80
SEED = 0  # weights, images and test inputs all come from it
# Launches of each serving-path kernel per request; mpbwd runs on the training path.
# topk counts stage 1 and the fused second top-k; dfl_boxes, off this path, is held at 0.
PER_REQUEST = {"stem": 1, "dw7x7": 2, "topk": 2, "s2dconv": 2, "bmm": 45, "argmax": 1}
# The bf16 routes every launch of the path takes: the tensor-core stem, the
# wgmma s2dconv, bmm's TMA + wgmma route.
NEW_ROUTES = {"stem_tc": "stem", "s2dconv_wgmma": "s2dconv", "bmm_wgmma": "bmm"}
# Top-k's k checked against its plain version at the decode shapes (and n).
TOPK_KS = (1, MAX_DET, 1000, 1024, 1025, 1500)
# Launches a request on the NMS path (one2many head: 45 bmm, as one2one's).
PER_REQUEST_NMS = {"stem": 1, "dw7x7": 2, "s2dconv": 2, "bmm": 45, "argmax": 1, "topk": 1, "nms": 1,
                   "dfl_boxes": 1}
# (batch, image size, k, nc) at which the fused second top-k (k stage 1's
# anchors) and the box decode (K3) are held to their plain versions: the
# top-k decode's [32, 300]
# and the NMS decode's [32, 1000] at 640 px, max_det 1500 at 320 px, batch 1,
# k = A, and class counts that hold no whole 16-byte vector a row.
DECODE_SHAPES = ((32, 640, 300, 80), (32, 640, 1000, 80), (8, 320, 1500, 80), (1, 640, 300, 80),
                 (1, 640, 1000, 80), (2, 128, 336, 80), (4, 320, 300, 3), (2, 256, 700, 37))
STRIDES = (8, 16, 32)
# (conf_thresh, iou_thresh): inference defaults and the validator's (validator.py:211-212).
NMS_SETTINGS = {"infer": (0.25, 0.45), "val": (0.001, 0.65)}
# The split of the NMS kernel that slice 7 wrote (a cluster an image building
# the n x n IoU bitmask, then a one-warp scan), on the path's candidates:
# per-phase %globaltimer stamps of an instrumented copy, mean over the
# images, on the first chip run of slice 14 (NVIDIA H100 80GB HBM3, 700.00 W).
# The kernel is gone; the line is printed beside the new one's times.
SLICE7_NMS_SPLIT = (
    "us a phase (load+valid, mask, scan, compaction) and the launch's span; [32,1000] fp32 at 0.25/0.45: "
    "2.000, 53.732, 29.180, 0.708, span 142.720 (device 0.1449 ms, events 0.1523; host 62.57 us a call through "
    "the operator, 18.37 direct); at 0.001/0.65: 1.964, 53.536, 38.860, 0.924, span 150.016 (device 0.1521); "
    "class-wise bf16 at 0.25/0.45: 2.052, 64.664, 65.964, 0.928, span 200.704 (device 0.2140, host 82.24 us); "
    "[1,1000] fp32 at 0.25/0.45: 2.048, 30.720, 29.952, 0.768 (device 0.0617 ms, events 0.0695; host 78.28 us, "
    "27.83 direct); at 0.001/0.65: 2.048, 30.464, 38.912, 1.024 (device 0.0706)")
LEVELS = ((80, 80), (40, 40), (20, 20))  # the head's maps at 640 px
# The sizes served folded in the variants phase, at full width and depth.
VARIANTS = ("yolov10n", "yolov10s", "yolov10m", "yolov10b", "yolov10l", "yolov10x")
VARIANT_BATCH = 2
# profile_step's stem a serving step, yolov10s 640 bf16 batch 32 (PERF.md
# section 6, the profile_step families): the variants phase's device time of
# that stem must be within 10%.
STEM_PROFILE_STEP_MS = (0.2671, 0.2700)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Processes the run starts beside its main thread: any still running when
# the run ends, a failure included, is killed.
JOBS: list = []


class Job:
    """A command started at once from the repository's root, its output
    going to files (so no full pipe stalls it); killed after `timeout`
    seconds. result() waits: (stdout, stderr, returncode, wall seconds from
    its start to its exit)."""

    def __init__(self, cmd, env=None, timeout: float = 900):
        self.files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
        self.timeout, self.wall = timeout, None
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([str(c) for c in cmd], cwd=HERE, env=env, stdout=self.files[0],
                                     stderr=self.files[1])
        JOBS.append(self)

    def done(self) -> bool:
        if self.wall is None:
            if self.proc.poll() is not None:
                self.wall = time.perf_counter() - self.t0
            elif time.perf_counter() - self.t0 > self.timeout:
                self.proc.kill()
        return self.wall is not None

    def result(self) -> tuple:
        while not self.done():
            time.sleep(0.05)
        out = []
        for f in self.files:
            f.seek(0)
            out.append(f.read())
        return out[0], out[1], self.proc.returncode, self.wall


def wait_all(jobs) -> list:
    """Wait for every job, each timed to its own exit: their results."""
    while not all([j.done() for j in jobs]):
        time.sleep(0.05)
    return [j.result() for j in jobs]


def free_ports(n: int) -> list:
    """n distinct free ports on this host, for jobs of ranks started at once."""
    from leanyolo_tpu_torch.parallel.distributed import free_port

    ports = []
    while len(ports) < n:
        port = free_port()
        if port not in ports:
            ports.append(port)
    return ports


@atexit.register
def stop_jobs() -> None:
    for j in JOBS:
        if j.proc.poll() is None:
            j.proc.kill()
            j.proc.wait()


KERNEL_INNER = 10
PROFILE_PAD_S = 0.05
# The kernel records of the last `profiled` call: {kernel name: count}, and
# [(kernel name, records, device microseconds)].
LAST_PROFILE = {}
LAST_EVENTS = []


def profiled(fn):
    """(fn()'s result, the device milliseconds of that call): the CUDA
    kernels' own time under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # A profile now and then comes back without device events, at times
    # three in a row; take the next, after a pause. Minutes into a run, a
    # profile of a few short kernels kept their runtime calls but lost some
    # or every kernel record; the profiler keeps only device records whose
    # timestamps fall inside its window, so the window is padded on each side
    # (idle time: the device time sums kernel durations only), by
    # PROFILE_PAD_S and twice as much at each try after. A profile that kept
    # some of its records is returned as it is: `device_ms` counts what it
    # kept (`records_ms`).
    for attempt in range(8):
        pad = PROFILE_PAD_S * 2 ** attempt
        if attempt:
            print(f"profiled: try {attempt + 1} of 8, pad {pad:.2f} s a side (the last profile kept no device time)",
                  flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            out = fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        ms = sum(e.self_device_time_total for e in events) / 1e3
        if ms > 0:
            LAST_PROFILE.clear()
            LAST_PROFILE.update({e.key: e.count for e in events})
            LAST_EVENTS[:] = [(e.key, e.count, e.self_device_time_total) for e in events]
            return out, ms
        time.sleep(0.2)
    seen = [(e.key[:60], e.device_type.name, e.count, e.self_device_time_total) for e in prof.key_averages()][:12]
    fail(f"torch.profiler recorded no device time in eight tries; the last profile's events: {seen}")


def records_ms(profiles, reps: int):
    """Device milliseconds a call from profiles of `reps` calls each, every
    profile's device records as [(kernel name, records kept, microseconds)],
    or None where they hold no record.

    A profile can lose records (`profiled`), so the sum over them divided
    by `reps` would fall with every lost one. A call takes each kernel's
    mean record time (over every record kept) times its records a call: the
    most records any profile kept of the kernel, over `reps`, rounded up. A
    lost record then lowers nothing unless a kernel lost `reps` or more of
    its records in every profile.
    """
    kept, total, most = {}, {}, {}
    for events in profiles:
        for k, c, t in events:
            kept[k], total[k] = kept.get(k, 0) + c, total.get(k, 0.0) + t
            most[k] = max(most.get(k, 0), c)
    if not any(kept.values()):
        return None
    return sum(total[k] / kept[k] * -(-most[k] // reps) for k in kept) / 1e3


def device_ms(fn, reps: int = KERNEL_INNER) -> float:
    """Device milliseconds per call of fn() over `reps` calls after a
    warm-up (`profiled`), free of the host's launch time (which a short
    kernel's CUDA-event time includes when the host enqueues slower than the
    card runs); see `records_ms`. Where a profile of several kernels lost
    records, it is taken again, three times at most, and the time comes from
    all of them (a profile of one kernel, a wrapper's, needs none: one
    record gives its time): a lost record never lowers a time."""
    import torch

    fn()
    torch.cuda.synchronize()
    profiles = []
    for _ in range(4):
        profiled(lambda: [fn() for _ in range(reps)])
        profiles.append(list(LAST_EVENTS))
        if len(LAST_EVENTS) == 1 or all(c % reps == 0 for _, c, _ in LAST_EVENTS):
            break
    ms = records_ms(profiles, reps)
    if ms is None:
        fail(f"device_ms: no kernel record in {len(profiles)} profiles of {reps} calls")
    return ms


# Seconds this run spends on the checks and times of the decode's kernels
# (the fused second top-k, K3, K4's flags), of the training BN's batch moments (K8)
# and of the task-aligned assignment (K6, K7), printed at its end.
DECODE_CHECK_S: dict = {}
BN_CHECK_S: dict = {}
TAL_CHECK_S: dict = {}


@contextlib.contextmanager
def check_time(store: dict, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        store[name] = store.get(name, 0.0) + time.perf_counter() - t0


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@contextlib.contextmanager
def plain_kernels():
    """Run the port with each kernel wrapper replaced by its plain version.

    The port has no such switch: the wrappers dispatch on the tensor's
    device alone. This swaps the module attributes the port calls through,
    for the all-plain reference run on the card only.
    """
    from leanyolo_tpu_torch.kernels import argmax, bnstats, dfl, dwconv, matmul, mpbwd, nms, s2dconv, stem, tal, topk

    saved = (stem.fused_stem, dwconv.dw7x7_bias_silu, topk.topk, mpbwd.mpbwd, s2dconv.conv3x3_c32_bias_silu,
             matmul.bmm, argmax.max_argmax_levels, nms.nms_compact, nms.nms_keep, argmax.max_argmax_flags,
             topk.topk_decode, dfl.dfl_boxes, bnstats.bn_moments, bnstats.bn_moments_bwd, tal.assign)
    stem.fused_stem = lambda *a, dtype=None, packed=None: stem.fused_stem_plain(*a, dtype=dtype or a[1].dtype)
    dwconv.dw7x7_bias_silu = dwconv.dw7x7_bias_silu_plain
    topk.topk = topk.topk_plain
    mpbwd.mpbwd = mpbwd.mpbwd_plain
    s2dconv.conv3x3_c32_bias_silu = s2dconv.conv3x3_c32_bias_silu_plain
    matmul.bmm = matmul.bmm_plain
    argmax.max_argmax_levels = argmax.max_argmax_levels_plain
    nms.nms_compact = nms.nms_compact_plain
    nms.nms_keep = nms.nms_keep_plain
    argmax.max_argmax_flags = argmax.max_argmax_flags_plain
    topk.topk_decode = topk.topk_decode_plain
    dfl.dfl_boxes = dfl.dfl_boxes_plain
    bnstats.bn_moments = bnstats.bn_moments_plain
    bnstats.bn_moments_bwd = bnstats.bn_moments_bwd_plain
    tal.assign = tal.assign_plain
    try:
        yield
    finally:
        (stem.fused_stem, dwconv.dw7x7_bias_silu, topk.topk, mpbwd.mpbwd, s2dconv.conv3x3_c32_bias_silu,
         matmul.bmm, argmax.max_argmax_levels, nms.nms_compact, nms.nms_keep, argmax.max_argmax_flags,
         topk.topk_decode, dfl.dfl_boxes, bnstats.bn_moments, bnstats.bn_moments_bwd, tal.assign) = saved


def capture_path_calls(folded, images):
    """The arguments of every s2dconv and bmm call of one forward of the
    folded model on `images` (the kernels run as usual)."""
    import torch
    from leanyolo_tpu_torch.kernels import matmul, s2dconv

    calls = {"s2dconv": [], "bmm": []}
    conv3, bmm = s2dconv.conv3x3_c32_bias_silu, matmul.bmm
    s2dconv.conv3x3_c32_bias_silu = lambda *a: calls["s2dconv"].append(a) or conv3(*a)
    matmul.bmm = lambda *a: calls["bmm"].append(a) or bmm(*a)
    try:
        with torch.inference_mode():
            folded(images, dtype=torch.bfloat16, branches=("one2one",), normalize=False, concat_head=False)
    finally:
        s2dconv.conv3x3_c32_bias_silu, matmul.bmm = conv3, bmm
    torch.cuda.synchronize()
    return calls


def calibrate(model, images, logits=None, var_scale: float = 1.0):
    """`model` (on the card) with each BN's running mean and variance set
    from what it sees in one forward of `images` (uint8 NHWC, on the card),
    the variance times `var_scale`; with logits=(mean, std), each final
    class conv is also rescaled so that its logits there have that mean and
    std per class. Returns the model on the CPU."""
    import torch
    from leanyolo_tpu_torch.models.yolov10.layers import BatchNorm

    def set_stats(bn, args):
        y = args[0].float()
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(y.var(dim=(0, 2, 3)) * var_scale)

    def spread(conv, args, out):
        mean, std = out.float().mean(dim=(0, 2, 3)), out.float().std(dim=(0, 2, 3))
        conv.weight.mul_((logits[1] / std).view(-1, 1, 1, 1))
        conv.bias.copy_((conv.bias - mean) * logits[1] / std + logits[0])

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules() if isinstance(m, BatchNorm)]
    if logits is not None:
        hooks += [seq[-1].register_forward_hook(spread) for seq in (*model.head.cv3, *model.head.one2one_cv3)]
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    return model.cpu()


def make_model(seed: int, variant: str = "yolov10s"):
    """`variant` at full width and depth, random weights from `seed`, BN
    statistics calibrated on one batch of random images.

    With fresh BN statistics (mean 0, var 1) the random net's activations
    fade layer by layer and every score lands near 0.5; setting each BN's
    running mean and variance from the batch it sees keeps them near unit
    scale, so the scores spread and the decode has a real ranking to get
    right.
    """
    import torch
    from leanyolo_tpu_torch import YOLOv10

    model = YOLOv10.create(variant, class_names=[f"c{i}" for i in range(NC)], seed=seed).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    images = torch.randint(0, 256, (4, IMGSZ, IMGSZ, 3), generator=g, device="cuda", dtype=torch.uint8)
    return calibrate(model, images)


def phase_kernels(folded, seed: int, records: dict) -> dict:
    """Each kernel against its plain version at its path's shapes; returns
    the s2dconv and bmm calls of one batch-32 forward for the timing phase."""
    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.kernels import dwconv, matmul, mpbwd, s2dconv, stem, topk

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    bb = folded.backbone
    w0, b0 = bb.cv0.conv.weight, bb.cv0.conv.bias
    w1, b1 = bb.cv1.conv.weight, bb.cv1.conv.bias
    images = torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ, 3), generator=g, device=dev, dtype=torch.uint8)

    # Tolerances: kernel and plain version round at the same points; their
    # fp32 sums differ in order, so a rounding can land one bf16 ulp apart
    # (2^-8 relative) and carry through the next layer. Limit: 4 ulps of the
    # output's largest magnitude in bf16, 1e-4 of it in fp32.
    # The path's shape with the weights the model packed once, and maps whose
    # W/4 is not a multiple of the tensor-core route's 16-column tile.
    ragged = [torch.randint(0, 256, s, generator=g, device=dev, dtype=torch.uint8)
              for s in ((2, 96, 160, 3), (1, 32, 32, 3))]
    for dtype, ulps in ((torch.bfloat16, 4 * 2.0 ** -8), (torch.float32, 1e-4)):
        ws = [t.to(dtype) for t in (w0, b0, w1, b1)]
        for x in [images] + ragged:
            ref = stem.fused_stem_plain(x, *ws, dtype=dtype)
            n = kernels.LAUNCHES["stem_tc"]
            got = stem.fused_stem(x, *ws, dtype=dtype, packed=(bb.stem_w0p, bb.stem_w1p))
            torch.cuda.synchronize()
            if kernels.LAUNCHES["stem_tc"] != n + (dtype == torch.bfloat16):
                fail(f"stem {dtype} did not take the route of its dtype")
            err, lim = max_err(got, ref), ulps * max(1.0, float(ref.float().abs().max()))
            print(f"kernel stem {dtype} {tuple(got.shape)}: max_abs_err {err:.6g} (limit {lim:.6g})", flush=True)
            b, h, w, _ = x.shape
            if not err <= lim or got.shape != (b, h // 4, w // 4, 64):
                fail("stem kernel disagrees with its plain version")
            if dtype == torch.bfloat16:
                records["stem"]["max_abs_err"] = max(records["stem"].get("max_abs_err", 0.0), err)

    # dw7x7 at the path's shape (one whole map per CTA in bf16, bands of
    # rows in fp32), a map split into bands in both types, and an odd C
    # (scalar copies and stores).
    dw = folded.backbone.c8.m[0].cv1[2]
    c = dw.conv.weight.shape[0]
    odd = dwconv.pack_weights(torch.randn(33, 1, 7, 7, generator=g, device=dev) * 0.1)
    for dtype, ulps in ((torch.bfloat16, 4 * 2.0 ** -8), (torch.float32, 1e-4)):
        for shape, w, b in (((BATCH, 20, 20, c), dw.w49, dw.conv.bias), ((4, 64, 64, c), dw.w49, dw.conv.bias),
                            ((2, 20, 20, 33), odd, odd[0] * 3)):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            w, b = w.to(dtype), b.to(dtype)
            ref = dwconv.dw7x7_bias_silu_plain(x, w, b)
            got = dwconv.dw7x7_bias_silu(x, w, b)
            torch.cuda.synchronize()
            err, lim = max_err(got, ref), ulps * max(1.0, float(ref.float().abs().max()))
            print(f"kernel dw7x7 {dtype} {tuple(got.shape)}: max_abs_err {err:.6g} (limit {lim:.6g})", flush=True)
            if not err <= lim:
                fail("dw7x7 kernel disagrees with its plain version")
            if dtype == torch.bfloat16:
                records["dw7x7"]["max_abs_err"] = max(records["dw7x7"].get("max_abs_err", 0.0), err)

    # Top-k at the decode shapes, bit-equal at every k of TOPK_KS: the
    # top-k decode's 300, the NMS decode's candidate 1000 (fp32 on that
    # path), both sides of the old cap of 1024, and k == n (rank
    # counting up to 2048, a bitonic sort above: in shared memory, or in
    # device memory for fp32 rows of 24000).
    worst = 0.0
    for n in (8400, 24000):
        for dtype in (torch.bfloat16, torch.float32):
            # Coarse values force many ties, signed zeros included.
            x = (torch.randn(BATCH, n, generator=g, device=dev) * 4).round() / 4
            x[:, ::7] = -0.0
            x = x.to(dtype)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            for k in TOPK_KS + (n,):
                for canon in (True, False):
                    rv, ri = topk.topk_plain(x, k, canon_zero=canon)
                    gv, gi = topk.topk(x, k, canon_zero=canon)
                    torch.cuda.synchronize()
                    same_idx, same_val = bool(torch.equal(gi, ri)), bool(torch.equal(gv.view(bits), rv.view(bits)))
                    if not (same_idx and same_val):
                        fail(f"topk kernel disagrees with its plain version: {dtype} [{BATCH},{n}] k={k} "
                             f"canon_zero={canon}: indices equal {same_idx}, value bits equal {same_val}")
                    worst = max(worst, max_err(gv, rv))
            print(f"kernel topk {dtype} [{BATCH},{n}] k in {list(TOPK_KS) + [n]}, canon_zero True and False: "
                  f"indices and value bits equal", flush=True)
    records["topk"]["max_abs_err"] = worst
    # decode_topk past the old cap: max_det = 1500 at 320 px (2100 anchors;
    # the second stage ranks 1500 x 80 pairs on 64-bit keys), kernel against
    # plain on the same tie-heavy maps.
    from leanyolo_tpu_torch.models.yolov10.decode import decode_topk

    maps = [tuple(((torch.randn(8, 320 // s, 320 // s, c, generator=g, device=dev) * 2).round() / 2).to(torch.bfloat16)
                  for c in (64, NC)) for s in (8, 16, 32)]
    n = kernels.LAUNCHES["topk"]
    d_k = decode_topk(maps, num_classes=NC, max_det=1500)
    with plain_kernels():
        d_p = decode_topk(maps, num_classes=NC, max_det=1500)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["topk"] != n + 2 or tuple(d_k.shape) != (8, 1500, 6) or not torch.equal(d_k, d_p):
        fail("decode_topk(max_det=1500) at 320 px: kernel and plain decodes differ")
    print("decode_topk max_det=1500 at 320 px, bf16 [8, 2100 anchors]: kernel and plain outputs bit-equal",
          flush=True)

    # mpbwd: bit-equal to its plain version (the same routing, the same f32
    # summation order): the 16-byte route at the SPPF shape of the training
    # path, an odd map and a map split into tiles; the general route at a C
    # that holds no whole 16-byte vector.
    worst = 0.0
    for shape in ((BATCH, 20, 20, 256), (3, 13, 17, 40), (2, 70, 90, 64), (3, 13, 17, 33)):
        for dtype in (torch.bfloat16, torch.float32):
            for ties in (False, True):
                x = torch.randn(shape, generator=g, device=dev)
                if ties:
                    x = (x * 2).round() / 2  # halves: windows hold their max twice
                x, dy = x.to(dtype), torch.randn(shape, generator=g, device=dev).to(dtype)
                ref = mpbwd.mpbwd_plain(x, dy)
                route = mpbwd.route(x, dy, ref)
                nv = kernels.LAUNCHES["mpbwd_vec"]
                got = mpbwd.mpbwd(x, dy)
                torch.cuda.synchronize()
                if kernels.LAUNCHES["mpbwd_vec"] != nv + (route == "vec"):
                    fail(f"mpbwd {dtype} {list(shape)} did not take its {route} route")
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = bool(torch.equal(got.view(bits), ref.view(bits)))
                print(f"kernel mpbwd {dtype} {list(shape)} ties={ties} ({route} route): bits equal {same}", flush=True)
                if not same:
                    fail("mpbwd kernel disagrees with its plain version")
                worst = max(worst, max_err(got, ref))
    records["mpbwd"]["max_abs_err"] = worst

    # s2dconv and bmm on the inputs of one batch-32 forward of the serving
    # path, cast to fp32 for the fp32 check, plus an odd shape each.
    calls = capture_path_calls(folded, images)
    if len(calls["s2dconv"]) != PER_REQUEST["s2dconv"] or len(calls["bmm"]) != PER_REQUEST["bmm"]:
        fail(f"one forward made {len(calls['s2dconv'])} s2dconv and {len(calls['bmm'])} bmm calls")
    x, w, b = calls["s2dconv"][0]
    odd = (torch.randn(3, 9, 7, 32, generator=g, device=dev), w, b)
    # Tolerance as for the stem: three rounding points, limit 4 bf16 ulps
    # (2^-8 each) of the output's largest magnitude, 1e-4 of it in fp32.
    for dtype, ulps in ((torch.bfloat16, 4 * 2.0 ** -8), (torch.float32, 1e-4)):
        for args in calls["s2dconv"] + [odd]:
            x, w, b = (t.to(dtype) for t in args)
            ref = s2dconv.conv3x3_c32_bias_silu_plain(x, w, b)
            n = kernels.LAUNCHES["s2dconv_wgmma"]
            got = s2dconv.conv3x3_c32_bias_silu(x, w, b)
            torch.cuda.synchronize()
            if kernels.LAUNCHES["s2dconv_wgmma"] != n + (dtype == torch.bfloat16):
                fail(f"s2dconv {dtype} did not take the route of its dtype")
            err, lim = max_err(got, ref), ulps * max(1.0, float(ref.float().abs().max()))
            print(f"kernel s2dconv {dtype} {list(x.shape)} (strides {list(x.stride())}): max_abs_err {err:.6g} "
                  f"(limit {lim:.6g})", flush=True)
            if not err <= lim:
                fail("s2dconv kernel disagrees with its plain version")
            if dtype == torch.bfloat16:
                records["s2dconv"]["max_abs_err"] = max(records["s2dconv"].get("max_abs_err", 0.0), err)

    # bmm with its epilogue, on each call's own bias and SiLU flag. The sum
    # rounds once: a flip from another summation order is one ulp, at most
    # 2^-7 of the element: limit 2 x 2^-8 of the largest magnitude in bf16
    # for a bare product; with bias and SiLU three rounding points, as for
    # the stem: 4 x 2^-8. fp32: 1e-4 of the largest magnitude.
    odd = (torch.randn(2, 37, 75, generator=g, device=dev), torch.randn(75, 33, generator=g, device=dev) * 0.1,
           torch.randn(33, generator=g, device=dev), True)
    for dtype, ulps in ((torch.bfloat16, 2.0 ** -8), (torch.float32, 1e-4)):
        worst, at = 0.0, None
        for x, w, bias, act in calls["bmm"] + [odd]:
            x, w = x.to(dtype), w.to(dtype)
            bias = None if bias is None else bias.to(dtype)
            ref = matmul.bmm_plain(x, w, bias, act)
            got = matmul.bmm(x, w, bias, act)
            torch.cuda.synchronize()
            units = (2 if bias is None and not act else 4) if dtype == torch.bfloat16 else 1
            err, lim = max_err(got, ref), units * ulps * max(1.0, float(ref.float().abs().max()))
            if not err <= lim:
                fail(f"bmm kernel disagrees with its plain version at x {list(x.shape)} w {list(w.shape)} "
                     f"bias {bias is not None} act {act}: {err} > {lim}")
            if err / lim >= worst:
                worst, at = err / lim, f"x {list(x.shape)} (strides {list(x.stride())}) w {list(w.shape)}"
            if dtype == torch.bfloat16:
                records["bmm"]["max_abs_err"] = max(records["bmm"].get("max_abs_err", 0.0), err)
        shapes = {(tuple(a[0].shape), tuple(a[1].shape)) for a in calls["bmm"]}
        print(f"kernel bmm {dtype}: the {len(calls['bmm'])} calls of a batch-{BATCH} forward ({len(shapes)} "
              f"distinct shapes) with their bias and SiLU, and [2,37,75]x[75,33] + bias + SiLU: all within limit; "
              f"worst max_abs_err/limit {worst:.4f} at {at}", flush=True)

    # The fused epilogue against the bias-free kernel followed by PyTorch's
    # bias add and SiLU, bf16: both round the very same fp32 sums at the same
    # points; the bias add is bit-equal, and the kernel's SiLU (the
    # hardware's approximate exp2 and reciprocal) parts from PyTorch's by a
    # few fp32 ulps, which flips a bf16 rounding now and then: one bf16 ulp.
    fused = [a for a in calls["bmm"] if a[2] is not None]
    differ = total = worst = 0
    for x, w, bias, act in fused:
        got = matmul.bmm(x, w, bias, act)
        sep = matmul.bmm(x, w) + bias
        sep = torch.nn.functional.silu(sep) if act else sep
        torch.cuda.synchronize()
        gap = bf16_ulps_apart(got, sep)
        differ += int((gap > 0).sum())
        total += gap.numel()
        worst = max(worst, int(gap.max()))
    print(f"kernel bmm fused epilogue vs bias-free kernel + PyTorch bias/SiLU, {len(fused)} calls: {differ} of "
          f"{total} bf16 outputs differ, by at most {worst} ulp", flush=True)
    if worst > 1:
        fail("bmm's fused epilogue is more than one bf16 ulp from the kernel + PyTorch's bias and SiLU")
    return calls


def decode_maps(g, b: int, size: int, nc: int, dtype, concat: bool):
    """Per level (reg [B, HW, 64], cls [B, HW, nc]) maps on the card, the
    head's at `size` px: coarse class logits with zeros of both signs; whole
    maps, or the slices of a concatenated [B, HW, 64 + nc] map (rows 64 + nc
    apart, read in place)."""
    import torch

    out = []
    for s in STRIDES:
        m = torch.randn(b, (size // s) ** 2, 64 + nc, generator=g, device="cuda") * 2
        c = (m[..., 64:] * 2).round() / 2
        c[..., ::3] = torch.where(c[..., ::3] == 0, torch.full_like(c[..., ::3], -0.0), c[..., ::3])
        m[..., 64:] = c
        m = m.to(dtype)
        out.append((m[..., :64], m[..., 64:]) if concat else (m[..., :64].contiguous(), m[..., 64:].contiguous()))
    return out


def bits_equal(x, y) -> bool:
    """The same shape, dtype and bits (NaNs' included)."""
    import torch

    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(x.dtype)
    return bool(torch.equal(x.view(view), y.view(view)) if view else torch.equal(x, y))


# Non-finite values put in image 1 of the decode's maps: (where, value); "two"
# is +inf at two anchors of one class column, "-inf16" a side's 16 bins.
NONFINITE = [(w, v) for w in ("cls", "reg") for v in ("+inf", "-inf", "nan", "two")] + [("reg", "-inf16")]


def poke_maps(levels, where: str, value: str, g):
    """Copies of per-level (reg, cls) maps with `value` at a random anchor of
    each level of image 1 (a class logit, or a reg bin)."""
    import torch

    v = {"+inf": float("inf"), "-inf": float("-inf"), "nan": float("nan"), "two": float("inf"),
         "-inf16": float("-inf")}[value]
    out = [(r.clone(), c.clone()) for r, c in levels]
    for r, c in out:
        a = int(torch.randint(0, c.shape[1], (1,), generator=g, device=c.device))
        col = int(torch.randint(0, c.shape[2], (1,), generator=g, device=c.device))
        if where == "cls":
            c[1, a, col] = v
            if value == "two":
                c[1, (a + 5) % c.shape[1], col] = v
        elif value == "-inf16":
            r[1, a, (col % 4) * 16:(col % 4 + 1) * 16] = v
        else:
            r[1, a, (col % 4) * 16 + 3] = v
    return out


def phase_decode_kernels(seed: int, records: dict) -> None:
    """The top-k decode's fused second top-k and the box decode (K3, NMS
    mode) against their plain versions on the card, bit-equal, at
    DECODE_SHAPES, bf16 and fp32, whole and concatenated maps: the fused op
    at k = min(300, pairs), 1 and past rank counting (2600 where the pairs
    allow), on the maps' flags; then, on batch-32 640 px maps with
    non-finite values in image 1, the flagging max/argmax (K4, both zero
    rules), the fused op on its flags and stage 1's anchors, and K3 with its
    flags, bit-equal to their plain versions."""
    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.kernels import argmax, dfl, topk

    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    worst = 0.0
    for b, size, k, nc in DECODE_SHAPES:
        hw = [(size // s, size // s) for s in STRIDES]
        a = sum(h * w for h, w in hw)
        k2s = sorted({min(MAX_DET, k * nc), 1, min(k * nc, 2600)})
        for dtype in (torch.bfloat16, torch.float32):
            for concat in (False, True):
                levels = decode_maps(g, b, size, nc, dtype, concat)
                regs, cls = [r for r, _ in levels], [c for _, c in levels]
                idx = torch.rand(b, a, generator=g, device="cuda").argsort(dim=1)[:, :k].int().contiguous()
                flags = argmax.flags_plain(cls, regs)
                n0 = dict(kernels.LAUNCHES)
                got, ref = [], []
                for k2 in k2s:
                    canon = dtype == torch.bfloat16 and k2 < k * nc <= 32768
                    got.append(topk.topk_decode(cls, regs, hw, STRIDES, idx, k2, canon_zero=canon, flags=flags))
                    ref.append(topk.topk_decode_plain(cls, regs, hw, STRIDES, idx, k2, canon_zero=canon, flags=flags))
                got.append(dfl.dfl_boxes(regs, hw, STRIDES, idx))
                ref.append(dfl.dfl_boxes_plain(regs, hw, STRIDES, idx))
                torch.cuda.synchronize()
                launched = (kernels.LAUNCHES["topk"] - n0["topk"], kernels.LAUNCHES["dfl_boxes"] - n0["dfl_boxes"])
                same = [bits_equal(x, y) for x, y in zip(got, ref)]
                if launched != (len(k2s), 1) or not all(same):
                    fail(f"decode kernels at [{b}, {k}] {size} px nc {nc} {dtype} concat={concat}: launches "
                         f"{launched}, bits equal (topk_decode at k {k2s}, dfl_boxes) {same}, "
                         f"max_abs_err {[max_err(x, y) for x, y in zip(got, ref)]}")
                worst = max(worst, *(max_err(x, y) for x, y in zip(got, ref)))
        print(f"kernel topk_decode (k {k2s}) and dfl_boxes (NMS mode) at [{b}, {k}] of {a} "
              f"anchors ({size} px), nc {nc}, bf16 and fp32, whole and concatenated maps: bit-equal to their plain "
              f"versions", flush=True)

    # Non-finite values: the flags as the decodes take them from K4.
    hw = [(IMGSZ // s, IMGSZ // s) for s in STRIDES]
    for dtype in (torch.bfloat16, torch.float32):
        base = decode_maps(g, BATCH, IMGSZ, NC, dtype, True)
        for where, value in NONFINITE:
            levels = poke_maps(base, where, value, g)
            regs, cls = [r for r, _ in levels], [c for _, c in levels]
            same = {}
            for canon in (False, True):
                got_k4 = argmax.max_argmax_flags(cls, regs, canon_zero=canon)
                same[f"k4 canon={canon}"] = all(bits_equal(x, y) for x, y in zip(
                    got_k4, argmax.max_argmax_flags_plain(cls, regs, canon_zero=canon)))
            vals, _, flags = argmax.max_argmax_flags(cls, regs, canon_zero=False)
            _, idx = topk.topk(vals, MAX_DET, canon_zero=dtype == torch.bfloat16)
            for k2 in (MAX_DET, 1):
                canon = dtype == torch.bfloat16
                same[f"topk_decode k={k2}"] = bits_equal(
                    topk.topk_decode(cls, regs, hw, STRIDES, idx, k2, canon_zero=canon, flags=flags),
                    topk.topk_decode_plain(cls, regs, hw, STRIDES, idx, k2, canon_zero=canon, flags=flags))
            _, anc = topk.topk(vals, 1000, canon_zero=False)
            boxes = dfl.dfl_boxes(regs, hw, STRIDES, anc, flags=flags)
            same["dfl_boxes flags"] = bits_equal(boxes, dfl.dfl_boxes_plain(regs, hw, STRIDES, anc, flags=flags))
            torch.cuda.synchronize()
            # Image 1 flagged, but for a single -inf bin (its side's DFL is finite); image 0 never.
            flagged = bool(flags[1].any()) == ((where, value) != ("reg", "-inf")) and not bool(flags[0].any())
            if not all(same.values()) or not flagged:
                fail(f"decode kernels on {dtype} maps with {value} in a {where} value of image 1: bits equal {same}, "
                     f"the flags of images 1 and 0 as expected {flagged}")
        print(f"kernel max_argmax_flags (both zero rules), topk_decode (k 300 and 1) and dfl_boxes (flags) on "
              f"[{BATCH},{IMGSZ}px] {dtype} maps with {[f'{v} in {w}' for w, v in NONFINITE]} in image 1: "
              f"bit-equal to their plain versions, NaNs' bits included", flush=True)
    records["topk_decode"]["max_abs_err"] = 0.0
    records["dfl_boxes"]["max_abs_err"] = worst


# The training BN's batch moments (K8): every input shape of a batch-32
# yolov10s 640 training forward (kernels/bounds.py::train_bn_shapes: 99 BNs,
# 14 shapes) in bf16, these three in fp32 too, and odd shapes: C = 33 (the
# general route), one row, row counts that leave the last step partial
# (steps of 32 G rows, kernels/bnstats.py::slots), C = 8, and a contiguous
# NCHW input (the general route, read in the same logical order). The step's
# shapes take the last CTA's reads in one round (G <= 128) and in two (its
# three maps above 2^18 rows, G = 256).
BN_FP32_SHAPES = ((BATCH, 32, 320, 320), (BATCH, 128, 80, 80), (BATCH, 512, 20, 20))
BN_ODD_SHAPES = ((2, 33, 17, 19), (1, 64, 1, 1), (3, 40, 37, 41), (5, 8, 45, 45))


@functools.lru_cache(maxsize=1)
def train_bn_shapes() -> tuple:
    """[N, C, H, W] of the 99 BN inputs of the training forward, in call order."""
    from leanyolo_tpu_torch.kernels import bounds

    return tuple(bounds.train_bn_shapes("yolov10s", IMGSZ, BATCH))


def bn_check(y, g, label: str, records: dict) -> None:
    """K8 forward and backward on y against their plain versions on the card,
    bit for bit, each launched three times (the same bits each time)."""
    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.kernels import bnstats

    n, c, h, w = y.shape
    route = bnstats.route(y)
    g1 = torch.randn(c, generator=g, device=y.device)
    g2 = torch.randn(c, generator=g, device=y.device) * 1e-3
    before = dict(kernels.LAUNCHES)
    runs = [bnstats.bn_moments(y) for _ in range(3)]
    druns = [bnstats.bn_moments_bwd(y, g1, g2) for _ in range(3)]
    torch.cuda.synchronize()
    ref, dref = bnstats.bn_moments_plain(y), bnstats.bn_moments_bwd_plain(y, g1, g2)
    vec = route == "vec"
    want = {"bn_moments": 3, "bn_moments_vec": 3 * vec, "bn_moments_bwd": 3, "bn_moments_bwd_vec": 3 * vec}
    got = {k: kernels.LAUNCHES[k] - before[k] for k in want}
    same = all(same_bits(a, b) for run in runs for a, b in zip(run, ref))
    dsame = all(same_bits(d, dref) and d.stride() == y.stride() for d in druns)
    g_, r = bnstats.slots(n * h * w, c), bnstats.rows_per_lane(n * h * w, c)
    print(f"kernel bn_moments {label} {str(y.dtype)[6:]} {list(y.shape)} ({route} route, {g_} slots, "
          f"{r} steps a lane): s1, s2 bit-equal to the plain version in each of three launches {same}; "
          f"bn_moments_bwd dy bit-equal in each of three {dsame}", flush=True)
    if got != want:
        fail(f"bn_moments {label} {list(y.shape)}: launches {got}, expected {want}")
    if not (same and dsame):
        fail(f"bn_moments {label} {list(y.shape)}: the kernels disagree with their plain versions (forward "
             f"{same}, backward {dsame}; largest gaps {[max_err(a, b) for a, b in zip(runs[0], ref)]}, "
             f"{max_err(druns[0], dref)})")
    for name in ("bn_moments", "bn_moments_bwd"):
        records[name]["max_abs_err"] = 0.0


def phase_bn_kernels(seed: int, records: dict) -> None:
    """K8 against its plain versions (see BN_FP32_SHAPES, BN_ODD_SHAPES)."""
    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.kernels import bnstats

    g = torch.Generator(device="cuda").manual_seed(seed + 18)

    def make(shape, dtype, mean=None, std=1.0, layout=torch.channels_last):
        """Normal values of std `std` about `mean` (default: a normal mean a channel)."""
        if mean is None:
            mean = torch.randn(1, shape[1], 1, 1, generator=g, device="cuda")
        return (torch.randn(shape, generator=g, device="cuda") * std + mean).to(dtype).contiguous(memory_format=layout)

    shapes = sorted(set(train_bn_shapes()), key=lambda s: -s[1] * s[2] * s[3])
    for shape in shapes:
        bn_check(make(shape, torch.bfloat16), g, "train path", records)
    for shape in BN_FP32_SHAPES:
        bn_check(make(shape, torch.float32), g, "train path", records)
    for shape in BN_ODD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            bn_check(make(shape, dtype), g, "odd", records)
    bn_check(make((BATCH, 64, 40, 40), torch.bfloat16, layout=torch.contiguous_format), g, "NCHW", records)
    # Cancellation: mean 1000, std 0.01 in fp32, where s2/n - mean^2 is rounding noise.
    y = make((BATCH, 64, 80, 80), torch.float32, mean=1000.0, std=0.01)
    bn_check(y, g, "mean 1000 std 0.01", records)
    s1, s2 = bnstats.bn_moments(y)
    rows = y.numel() // y.shape[1]
    mean = s1 / rows
    raw = s2 / rows - mean * mean  # as _BatchMoments forms it
    print(f"mean 1000 std 0.01: s2/n - mean^2 is 0 or below in {int((raw <= 0).sum())} of {raw.numel()} channels "
          f"(the variance clamps there), at most {float(raw.abs().max()):.4g}", flush=True)
    n = kernels.LAUNCHES["bn_moments"]
    s1, s2 = bnstats.bn_moments(torch.zeros(0, 16, 4, 4, device="cuda", dtype=torch.bfloat16))
    if kernels.LAUNCHES["bn_moments"] != n or s1.tolist() != [0.0] * 16 or s2.tolist() != [0.0] * 16:
        fail("bn_moments of an empty input: expected zero sums and no launch")


def bf16_ulps_apart(a, b):
    """Per element, how many bf16 steps lie between a and b (+0 == -0)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def check_dets(dets, num, b: int) -> None:
    import torch

    if tuple(dets.shape) != (b, MAX_DET, 6) or tuple(num.shape) != (b,):
        fail(f"dets shape {tuple(dets.shape)}, num shape {tuple(num.shape)}")
    if not bool(torch.isfinite(dets).all()):
        fail("non-finite detections")
    cls, scores = dets[..., 5], dets[..., 4]
    if not bool(((cls >= 0) & (cls < NC) & (cls == cls.round())).all()):
        fail("classes are not integers in [0, 80)")
    if not bool(((scores >= 0) & (scores <= 1)).all()):
        fail("scores outside [0, 1]")
    if not bool((scores[:, 1:] <= scores[:, :-1]).all()):
        fail("scores not sorted in descending order")


def check_paths(pred, pred32, x, label: str, pred32_cpu=None) -> None:
    """The kernel path against the all-plain path on the card, on uint8
    images x: bf16 (`pred`) and fp32 (`pred32`) folded predictors of one
    model; then the decode on identical head maps. `pred32_cpu`, an fp32
    predictor of the same model on the CPU, gives the fp32 noise floor."""
    import torch
    from leanyolo_tpu_torch.models.yolov10.decode import decode_topk

    maps_k, maps_k32 = pred.raw(x), pred32.raw(x)
    with plain_kernels():
        maps_p, maps_p32 = pred.raw(x), pred32.raw(x)
    maps_c32 = pred32_cpu.raw(x.cpu()) if pred32_cpu is not None else None
    torch.cuda.synchronize()
    # fp32: the kernels change only the order of fp32 sums; the maps agree
    # to 1e-3 of their scale. Where a net is deep enough to grow fp32
    # summation noise past that (yolov10l/x at full depth: every kernel
    # alone is within 1e-6 of scale), the limit is that noise itself: the
    # RMS gap between kernel and plain fp32 maps on the card may not exceed
    # the RMS gap between the plain fp32 maps on the card and on the CPU,
    # which differ in the order of every conv's sums. bf16: both paths round
    # at the same points, but a one-ulp flip from another summation order
    # grows through the ~90 layers of a net whose BN keeps activations at
    # unit scale. The limit is the bf16 rounding noise itself: the RMS gap
    # between kernel and plain bf16 maps may not exceed the RMS gap between
    # the plain bf16 and the plain fp32 maps.
    for lvl in range(3):
        for j, name in enumerate(("reg", "cls")):
            k32, p32 = maps_k32[lvl][j].float(), maps_p32[lvl][j].float()
            err32, scale = max_err(k32, p32), float(p32.abs().max())
            kb, pb = maps_k[lvl][j].float(), maps_p[lvl][j].float()
            gap_k = float((kb - pb).pow(2).mean().sqrt())
            gap_bf16 = float((pb - p32).pow(2).mean().sqrt())
            floor = ""
            ok32 = err32 <= 1e-3 * max(1.0, scale)
            if maps_c32 is not None:
                c32 = maps_c32[lvl][j].float().cuda()
                gap_k32, gap_dev = float((k32 - p32).pow(2).mean().sqrt()), float((c32 - p32).pow(2).mean().sqrt())
                floor = (f" (rms {gap_k32:.6g}; plain fp32 card vs CPU rms {gap_dev:.6g}, max "
                         f"{max_err(c32, p32):.6g})")
                ok32 = ok32 or gap_k32 <= gap_dev
            print(f"{label} head P{lvl + 3} {name}: fp32 kernel vs plain max_abs_err {err32:.6g} of scale "
                  f"{scale:.6g}{floor}; bf16 kernel vs plain rms {gap_k:.6g} (max {max_err(kb, pb):.6g}), "
                  f"bf16 vs fp32 plain rms {gap_bf16:.6g}", flush=True)
            if not ok32:
                fail(f"{label}: fp32 kernel path disagrees with the plain path on the head maps")
            if not gap_k <= gap_bf16:
                fail(f"{label}: bf16 kernel path is further from the plain path than bf16 rounding allows")
    strides = pred.model.cfg.strides
    with torch.inference_mode():
        d_k = decode_topk(maps_k, num_classes=NC, strides=strides, max_det=MAX_DET)
        with plain_kernels():
            d_p = decode_topk(maps_k, num_classes=NC, strides=strides, max_det=MAX_DET)
    torch.cuda.synchronize()
    if not torch.equal(d_k, d_p):
        fail(f"{label}: decode on identical head maps differs between the top-k kernel and its plain version")
    print(f"{label} decode on identical head maps: kernel and plain outputs bit-equal", flush=True)


def decode_topk_on(pred, maps):
    """The top-k decode of `pred`'s requests on the head maps `maps`."""
    from leanyolo_tpu_torch.models.yolov10.decode import decode_topk

    return (decode_topk(maps, num_classes=NC, strides=pred.model.cfg.strides, max_det=MAX_DET),)


def decode_nms_on(pred, maps):
    """The NMS decode of `pred`'s requests (its thresholds, fp32 ranking) on the head maps `maps`."""
    import torch
    from leanyolo_tpu_torch.models.yolov10.decode import decode_nms

    return decode_nms(maps, num_classes=NC, strides=pred.model.cfg.strides, conf_thresh=pred.conf_thresh,
                      iou_thresh=pred.iou_thresh, max_det=MAX_DET, class_wise=pred.class_wise_nms,
                      rank_dtype=torch.float32)


def check_decodes(decode, preds: dict, x32, label: str) -> None:
    """`decode(pred, maps)` with the kernels against the all-plain decode on
    identical head maps, bit for bit, for each predictor of `preds` (bf16
    and fp32 maps) at batch 1, 8 and 32: one forward of the batch-32
    request a predictor, its maps' first images for the smaller batches."""
    import torch

    with check_time(DECODE_CHECK_S, f"{label} decodes on identical maps"):
        for dt, pred in preds.items():
            full = pred.raw(x32)
            for b in (1, 8, BATCH):
                maps = [tuple(t[:b] for t in lvl) for lvl in full]
                with torch.inference_mode():
                    got = decode(pred, maps)
                    with plain_kernels():
                        ref = decode(pred, maps)
                torch.cuda.synchronize()
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    fail(f"{label} decode on identical {dt} head maps at batch {b}: kernels and plain versions "
                         f"differ")
            del full
        print(f"{label} decode on identical head maps at batch 1, 8 and {BATCH} ({', '.join(preds)} maps): kernels "
              f"and plain versions bit-equal", flush=True)


def phase_main(model, seed: int, records: dict):
    """Serve the requests, check them, compare paths; returns the predictor
    and the batch-32 request on the card for the timing phase."""
    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, kernels

    pred = Predictor(model, imgsz=IMGSZ, decode="topk", dtype="bfloat16", fuse=True, max_det=MAX_DET)
    rng = np.random.RandomState(seed)
    requests = {b: rng.randint(0, 256, (b, IMGSZ, IMGSZ, 3)).astype(np.uint8) for b in (1, 8, BATCH)}

    results, launches, fused = {}, {name: 0 for name in PER_REQUEST}, 0
    for b, imgs in requests.items():
        kernels.reset_launches()
        results[b] = pred.run_batch(imgs)
        torch.cuda.synchronize()
        got = {name: kernels.LAUNCHES[name] for name in PER_REQUEST}
        routes = {name: kernels.LAUNCHES[name] for name in NEW_ROUTES}
        print(f"request batch {b}: launches {got} (dfl_boxes {kernels.LAUNCHES['dfl_boxes']}), on the bf16 routes "
              f"{routes}", flush=True)
        if got != PER_REQUEST or kernels.LAUNCHES["dfl_boxes"] or kernels.LAUNCHES["topk_decode"] != 1:
            fail(f"request batch {b} launched {got}, dfl_boxes {kernels.LAUNCHES['dfl_boxes']} and topk_decode "
                 f"{kernels.LAUNCHES['topk_decode']}, expected {PER_REQUEST} a request, no dfl_boxes and one "
                 f"topk_decode (one of the two topk)")
        fused += kernels.LAUNCHES["topk_decode"]
        for name, of in NEW_ROUTES.items():
            if routes[name] != PER_REQUEST[of]:
                fail(f"request batch {b}: {routes[name]} of {PER_REQUEST[of]} {of} launches on the {name} route")
            records[of][f"{name}_launches"] = records[of].get(f"{name}_launches", 0) + routes[name]
        for name, n in got.items():
            launches[name] += n
    print(f"serving path launches over requests of batch {list(requests)}: {launches}, topk_decode {fused} of the "
          f"topk", flush=True)
    for name, n in launches.items():
        records[name]["launches"] = n
    records["topk_decode"]["launches"] = fused
    for b, (dets, num) in results.items():
        check_dets(dets, num, b)
        print(f"request batch {b}: dets {tuple(dets.shape)}, num above conf {num.tolist()[:8]}, "
              f"top score {float(dets[0, 0, 4]):.4f}", flush=True)

    # Kernel path against the all-plain path on the card, on the batch of 8.
    pred32 = Predictor(model, imgsz=IMGSZ, dtype="float32", fuse=True)
    check_paths(pred, pred32, torch.from_numpy(requests[8]).cuda(), "yolov10s")
    check_decodes(decode_topk_on, {"bf16": pred, "fp32": pred32}, torch.from_numpy(requests[BATCH]).cuda(), "top-k")
    del pred32

    # fp32 on the card (kernels) against fp32 on the CPU (plain), small input.
    small = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    gpu32 = Predictor(model, imgsz=128, dtype="float32", fuse=True).raw(small)
    cpu32 = Predictor(model, imgsz=128, dtype="float32", fuse=True, device="cpu").raw(small)
    for lvl, (g_, c_) in enumerate(zip(gpu32, cpu32)):
        for a, b in zip(g_, c_):
            err, scale = max_err(a.cpu(), b), float(b.abs().max())
            if not err <= 1e-3 * max(1.0, scale):
                fail(f"fp32 card vs CPU head map P{lvl + 3}: max_abs_err {err} of scale {scale}")
    print("fp32 head maps, card vs CPU at [2,128,128,3]: within 1e-3 of scale", flush=True)
    return pred, torch.from_numpy(requests[BATCH]).cuda()


def time_stem(bb, g, plain: bool = False, device: bool = True) -> dict:
    """The bf16 stem of a folded backbone `bb` at [32,640,640,3] uint8, as
    the path calls it (weights packed once): the kernel (CUDA events and,
    where `device`, device time), cuDNN's conv + bias + SiLU twice in channels_last, the
    plain version where asked, the bound, and the SiLU floor (two
    special-function operations (ex2, rcp) per conv0 output, with the 8x16
    tile's halo 561 of every 512, and per conv1 output, 16 a clock per SM; a
    model, not a measurement, so it stays out of the kernels line)."""
    import torch
    import torch.nn.functional as F
    from leanyolo_tpu_torch.kernels import bounds, stem

    dev, bf = "cuda", torch.bfloat16
    w0, b0, w1, b1 = (t.to(dev, bf) for t in (bb.cv0.conv.weight, bb.cv0.conv.bias, bb.cv1.conv.weight,
                                               bb.cv1.conv.bias))
    c0, c1 = w0.shape[0], w1.shape[0]
    images = torch.randint(0, 256, (BATCH, IMGSZ, IMGSZ, 3), generator=g, device=dev, dtype=torch.uint8)
    w0c, w1c = w0.contiguous(memory_format=torch.channels_last), w1.contiguous(memory_format=torch.channels_last)

    def library():
        x = images.permute(0, 3, 1, 2).to(bf, memory_format=torch.channels_last)
        return F.silu(F.conv2d(F.silu(F.conv2d(x, w0c, b0, 2, 1)), w1c, b1, 2, 1))

    packed = (bb.stem_w0p, bb.stem_w1p)
    r = {}
    r["ms"] = events_ms(lambda: stem.fused_stem(images, w0, b0, w1, b1, packed=packed), inner=KERNEL_INNER)
    if device:
        r["device_ms"] = device_ms(lambda: stem.fused_stem(images, w0, b0, w1, b1, packed=packed))
    if plain:
        r["plain_ms"] = events_ms(lambda: stem.fused_stem_plain(images, w0, b0, w1, b1, dtype=bf), inner=KERNEL_INNER)
    r["library_ms"] = events_ms(library, inner=KERNEL_INNER)
    r["bound_ms"], r["bound_by"] = bounds.bound(*bounds.stem_work(BATCH, IMGSZ, IMGSZ, c0, c1))
    sms, clock = torch.cuda.get_device_properties(0).multi_processor_count, sm_clock_hz()
    h0, h1 = IMGSZ // 2, IMGSZ // 4
    silus = BATCH * (h0 * h0 * c0 * 561 / 512 + h1 * h1 * c1)
    r["silu_floor_ms"] = 2 * silus / (16 * sms * clock) * 1e3
    return r


def time_decode_kernels(records: dict, pred, x32) -> None:
    """The fused second top-k on the top-k decode's inputs of a batch-32
    request (the one2one head's maps, K4's flags, stage 1's 300 anchors):
    events, device ms, host us a call; its plain composition; and, for the
    split, the stage-2 top-k kernel alone on the same gathered pairs."""
    import torch
    from leanyolo_tpu_torch.kernels import argmax, bounds, gather, topk

    maps = pred.raw(x32)
    cls = [c.reshape(BATCH, -1, NC) for _, c in maps]
    regs = [r.reshape(BATCH, -1, r.shape[-1]) for r, _ in maps]
    hw = [tuple(c.shape[1:3]) for _, c in maps]
    vals, _, flags = argmax.max_argmax_flags(cls, regs, canon_zero=False)
    _, idx = topk.topk(vals, MAX_DET, canon_zero=True)
    call = lambda: topk.topk_decode(cls, regs, hw, STRIDES, idx, MAX_DET, canon_zero=True,  # noqa: E731
                                    flags=flags)
    r = records["topk_decode"]
    r["ms"] = events_ms(call, inner=KERNEL_INNER)
    r["device_ms"] = device_ms(call)
    r["host_us"] = host_us(call, n=200)
    r["plain_ms"] = events_ms(lambda: topk.topk_decode_plain(cls, regs, hw, STRIDES, idx, MAX_DET, canon_zero=True,
                                                           flags=flags), inner=KERNEL_INNER)
    r["library_ms"] = None
    set_bound(r, *bounds.topk_decode_work(BATCH, MAX_DET, NC, MAX_DET, cls[0].element_size()), "fp32")
    sel = gather.gather_rows_plain(cls, idx, flags).reshape(BATCH, -1)
    alone = lambda: topk.topk(sel, MAX_DET, canon_zero=True)  # noqa: E731
    r["stage2_topk_ms"], r["stage2_topk_device_ms"] = events_ms(alone, inner=KERNEL_INNER), device_ms(alone)
    print(f"topk_decode [{BATCH},{MAX_DET}] x {NC} bf16 pairs of the three levels -> [{BATCH},{MAX_DET},6], one "
          f"launch: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), host {r['host_us']:.2f} us a call; plain "
          f"composition {r['plain_ms']:.4f}, library none, bound {r['bound_ms']:.6f} ({r['bound_by']}); the "
          f"stage-2 top-k kernel alone on the same pairs {r['stage2_topk_ms']:.4f} (device "
          f"{r['stage2_topk_device_ms']:.4f})", flush=True)


def phase_times(folded, seed: int, records: dict, pred, x32, calls: dict) -> dict:
    """Times of the kernels and the serving step; returns the serving step's
    profile ({"total_ms": device ms a step, "families": {family: ms a
    step}}, families as utils/profiling.py groups kernels)."""
    import torch
    import torch.nn.functional as F
    from leanyolo_tpu_torch.kernels import bounds, dwconv, matmul, s2dconv, stem, topk

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    bf = torch.bfloat16

    r = records["stem"]
    r.update(time_stem(folded.backbone, g, plain=True))
    print(f"stem yolov10s [{BATCH},{IMGSZ},{IMGSZ},3] uint8 -> bf16: kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f}, cuDNN conv+bias+SiLU x2 {r['library_ms']:.4f}, bound "
          f"{r['bound_ms']:.6f} ({r['bound_by']}), SiLU floor {r.pop('silu_floor_ms'):.6f}", flush=True)
    sms, clock = torch.cuda.get_device_properties(0).multi_processor_count, sm_clock_hz()

    # dw7x7 with the weights the model packed once ([49, C] bf16), as the
    # path calls it.
    dw = folded.backbone.c8.m[0].cv1[2]
    c = dw.conv.weight.shape[0]
    x = torch.randn(BATCH, 20, 20, c, generator=g, device=dev).to(bf)
    w49, w, b = dw.w49, dw.conv.weight, dw.conv.bias
    xc = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC tensor
    wc = w.contiguous(memory_format=torch.channels_last)
    r = records["dw7x7"]
    r["ms"] = events_ms(lambda: dwconv.dw7x7_bias_silu(x, w49, b), inner=KERNEL_INNER)
    r["plain_ms"] = events_ms(lambda: dwconv.dw7x7_bias_silu_plain(x, w49, b), inner=KERNEL_INNER)
    r["library_ms"] = events_ms(lambda: F.silu(F.conv2d(xc, wc, b, 1, 3, 1, c)), inner=KERNEL_INNER)
    set_bound(r, 2 * x.numel() * 2 + 2 * (w.numel() + b.numel()), 2 * 49 * x.numel(), "bf16")
    print(f"dw7x7 {list(x.shape)} bf16: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, cuDNN conv+bias+SiLU "
          f"{r['library_ms']:.4f}, bound {r['bound_ms']:.6f} ({r['bound_by']})", flush=True)

    # Top-k at both decode shapes; the record sums the pair, as the main path
    # launches one of each per request. Past the path's k, the times at k =
    # 1500 and k = n are printed (no record).
    r = records["topk"]
    ms = dev_ms = plain = lib = 0.0
    nbytes = nops = 0
    for n in (8400, 24000):
        xs = torch.randn(BATCH, n, generator=g, device=dev).to(bf)
        ms += events_ms(lambda: topk.topk(xs, MAX_DET, canon_zero=True), inner=KERNEL_INNER)
        dev_ms += device_ms(lambda: topk.topk(xs, MAX_DET, canon_zero=True))
        plain += events_ms(lambda: topk.topk_plain(xs, MAX_DET, canon_zero=True), inner=KERNEL_INNER)
        lib += events_ms(lambda: torch.topk(xs, MAX_DET, dim=-1), inner=KERNEL_INNER)
        print(f"topk [{BATCH},{n}] k={MAX_DET}: cumulative kernel {ms:.4f} ms (device {dev_ms:.4f}), plain "
              f"{plain:.4f}, torch.topk {lib:.4f}", flush=True)
        for k in (1500, n):
            t_k = events_ms(lambda: topk.topk(xs, k, canon_zero=True), inner=KERNEL_INNER)
            t_l = events_ms(lambda: torch.topk(xs, k, dim=-1), inner=KERNEL_INNER)
            print(f"topk [{BATCH},{n}] bf16 k={k}: kernel {t_k:.4f} ms, torch.topk {t_l:.4f}", flush=True)
        nb, no = bounds.topk_work(BATCH, n, MAX_DET, xs.element_size())
        nbytes, nops = nbytes + nb, nops + no
    r.update(ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib)
    set_bound(r, nbytes, nops, "fp32")
    with check_time(DECODE_CHECK_S, "the fused second top-k timed"):
        time_decode_kernels(records, pred, x32)

    # s2dconv, one launch at [32,160,160,32] (the input of c2.m[0].cv1, made
    # contiguous for all three); the library call is cuDNN's conv + bias +
    # SiLU in channels_last on the 3x3 weights.
    x, w_s2d, b = calls["s2dconv"][0]
    x = x.contiguous()
    cv1 = folded.backbone.c2.m[0].cv1
    w3 = cv1.conv.weight.contiguous(memory_format=torch.channels_last)
    xc = x.permute(0, 3, 1, 2)  # channels_last view of the NHWC tensor
    r = records["s2dconv"]
    r["ms"] = events_ms(lambda: s2dconv.conv3x3_c32_bias_silu(x, w_s2d, b), inner=KERNEL_INNER)
    r["device_ms"] = device_ms(lambda: s2dconv.conv3x3_c32_bias_silu(x, w_s2d, b))
    r["plain_ms"] = events_ms(lambda: s2dconv.conv3x3_c32_bias_silu_plain(x, w_s2d, b), inner=KERNEL_INNER)
    r["library_ms"] = events_ms(lambda: F.silu(F.conv2d(xc, w3, b, 1, 1)), inner=KERNEL_INNER)
    set_bound(r, *bounds.s2dconv_work(*x.shape[:3], elt=x.element_size()), "bf16")
    silu_floor = 2 * x.numel() / (16 * sms * clock) * 1e3
    print(f"s2dconv {list(x.shape)} bf16: kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
          f"{r['plain_ms']:.4f}, cuDNN conv+bias+SiLU {r['library_ms']:.4f}, bound {r['bound_ms']:.6f} "
          f"({r['bound_by']}), SiLU floor {silu_floor:.6f}", flush=True)

    # bmm, summed over the 45 calls of a batch-32 request on their own
    # inputs, each with its bias and SiLU; the library call is torch.matmul
    # on the same operands (the product alone). The bound is each call's
    # bound, summed. Beside the CUDA-event times, the kernel's and
    # torch.matmul's device times (profiler): the short 20x20 calls are
    # host-bound under CUDA events. The same timings, grouped by shape, give
    # the per-shape table.
    r = records["bmm"]
    ms = plain = lib = bound_ms = t_bytes = t_ops = k_dev = l_dev = 0.0
    per_shape = {}
    for x, w, bias, act in calls["bmm"]:
        k_ms = events_ms(lambda: matmul.bmm(x, w, bias, act), inner=KERNEL_INNER)
        plain += events_ms(lambda: matmul.bmm_plain(x, w, bias, act), inner=KERNEL_INNER)
        l_ms = events_ms(lambda: torch.matmul(x, w), inner=KERNEL_INNER)
        kd_ms = device_ms(lambda: matmul.bmm(x, w, bias, act))
        ld_ms = device_ms(lambda: torch.matmul(x, w))
        k_dev, l_dev = k_dev + kd_ms, l_dev + ld_ms
        nbytes, nops = bounds.bmm_work(*x.shape, w.shape[1], elt=x.element_size())
        b_ms = max(nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S["bf16"]) * 1e3
        ms, lib, bound_ms = ms + k_ms, lib + l_ms, bound_ms + b_ms
        t_bytes += nbytes / HBM_BYTES_PER_S * 1e3
        t_ops += nops / PEAK_OPS_PER_S["bf16"] * 1e3
        route, plan = matmul.route(x, matmul._row_stride(x) or x.shape[2], w.shape[1])
        key = (x.shape[0] * x.shape[1], x.shape[2], w.shape[1])
        tile = f"128x{plan[0]},{plan[1]}p" if plan else "mma.sync"
        row = per_shape.setdefault(key, {"calls": 0, "ms": 0.0, "lib": 0.0, "kdev": 0.0, "ldev": 0.0, "bound": 0.0,
                                         "route": route, "tile": tile})
        row["calls"] += 1
        for name, v in (("ms", k_ms), ("lib", l_ms), ("kdev", kd_ms), ("ldev", ld_ms), ("bound", b_ms)):
            row[name] += v
    r.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound_ms, device_ms=k_dev, library_device_ms=l_dev,
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"bmm, {len(calls['bmm'])} calls of a batch-{BATCH} request, summed: kernel {ms:.4f} ms, plain {plain:.4f}, "
          f"torch.matmul {lib:.4f}, bound {bound_ms:.6f} ({r['bound_by']}); device time: kernel {k_dev:.4f} ms, "
          f"torch.matmul {l_dev:.4f}", flush=True)
    print("bmm per shape (rows = B*H*W, K, N; summed over the request's calls of that shape): calls route "
          "tile,consumer-pairs kernel_ms torch.matmul_ms | device: kernel_ms torch.matmul_ms | bound_ms "
          "device kernel/matmul kernel/bound", flush=True)
    for (rows, k, n), row in sorted(per_shape.items(), key=lambda kv: -kv[1]["kdev"]):
        print(f"  {rows:7d} {k:5d} {n:4d}  {row['calls']:2d} {row['route']} {row['tile']:11s} {row['ms']:.4f} "
              f"{row['lib']:.4f} | {row['kdev']:.4f} {row['ldev']:.4f} | {row['bound']:.5f} "
              f"{row['kdev'] / row['ldev']:.2f} {row['kdev'] / row['bound']:.2f}", flush=True)

    # The serving step, kernels against plain versions in turns (plain,
    # kernel, kernel, plain) so drift in the card's clocks shows.
    step = {"kernels": [], "plain": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        ctx = plain_kernels() if which == "plain" else contextlib.nullcontext()
        with ctx:
            step[which].append(events_ms(lambda: pred.run_batch(x32), warmup=3, runs=20))
    for which, ms in step.items():
        print(f"serving path yolov10s 640 bf16 batch {BATCH}, {which}: ms/batch {ms[0]:.4f} {ms[1]:.4f}, "
              f"img/s {BATCH / ms[0] * 1e3:.2f} {BATCH / ms[1] * 1e3:.2f} (uint8 batch already on the card)",
              flush=True)

    # Where the serving step's device time goes, by kernel (5 steps).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            pred.run_batch(x32)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    print(f"profile, 5 steps at batch {BATCH}: device time {total / 5 / 1e3:.4f} ms/step; top kernels:", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"  {e.self_device_time_total / 5 / 1e3:9.4f} ms/step {e.count // 5:5d} calls/step  {e.key[:90]}", flush=True)
    # The port's kernels by device time (bmm: both of its routes' kernels).
    ours = {"stem tc": "stem_tc_kernel", "stem fp32": "stem_kernel<", "dw7x7": "dw7x7_kernel",
            "topk": "topk_kernel", "topk_decode": "topk_decode_kernel", "s2dconv wgmma": "s2d_wgmma_kernel",
            "s2dconv fp32": "S2DProblem",
            "bmm wgmma": "sm90::gemm_kernel", "bmm mma.sync": "MatmulProblem", "argmax": "argmax_kernel",
            "dfl_boxes (none on this path)": "dfl_boxes_kernel"}
    for name, tag in ours.items():
        es = [e for e in events if tag in e.key]
        print(f"profile: {name} kernels {sum(e.self_device_time_total for e in es) / 5 / 1e3:.4f} ms/step in "
              f"{sum(e.count for e in es) // 5} calls/step", flush=True)
    # PyTorch's elementwise kernels (bias and residual adds, SiLU, other
    # binary ops), the passes the fused epilogue removes.
    elem = [e for e in events if "elementwise_kernel" in e.key and "copy" not in e.key.lower()]
    silu = [e for e in elem if "silu" in e.key.lower()]
    per_step = lambda es: (sum(e.count for e in es) // 5, sum(e.self_device_time_total for e in es) / 5 / 1e3)
    (n_elem, t_elem), (n_silu, t_silu) = per_step(elem), per_step(silu)
    print(f"profile: PyTorch elementwise kernels (copies aside) {n_elem} calls/step ({t_elem:.4f} ms): SiLU "
          f"{n_silu} ({t_silu:.4f} ms), the rest {n_elem - n_silu} ({t_elem - t_silu:.4f} ms); before the fused "
          f"epilogue: 66 SiLU + 126 others = 192 calls/step", flush=True)
    from leanyolo_tpu_torch.utils.profiling import _family

    families = {}
    for e in events:
        families[_family(e.key)] = families.get(_family(e.key), 0.0) + e.self_device_time_total / 5 / 1e3
    return {"total_ms": total / 5 / 1e3, "families": families, "run_batch_ms": min(step["kernels"])}


def argmax_rows(g, shape, dtype):
    """Coarse values (maxima repeated in a row) with rows of signed zeros:
    all -0.0, -0.0 before +0.0, and negative rows whose max is a zero."""
    import torch

    x = (torch.randn(shape, generator=g, device="cuda") * 2).round() / 2
    r = x.shape[-2]
    x[..., : r // 8, :] = 0.0
    x[..., : r // 8, ::3] = -0.0
    x[..., r // 8: r // 4, :] = -x[..., r // 8: r // 4, :].abs() - 1.0
    x[..., r // 8: r // 4, 7] = -0.0
    x[..., r // 8: r // 4, 11] = 0.0
    x[..., r // 4: r // 4 + 2, :] = -0.0
    return x.to(dtype)


def nms_inputs(g, b: int, n: int, grid: bool):
    """Score-sorted NMS candidates on the card: boxes on an integer grid
    (IoUs exactly at 0.5, 1/3, ...) or spread over a 640 px image, scores
    descending with ties, classes 0..79."""
    import torch

    if grid:
        xy = torch.randint(0, 8, (b, n, 2), generator=g, device="cuda").float()
        wh = torch.randint(1, 5, (b, n, 2), generator=g, device="cuda").float()
    else:
        xy = torch.rand(b, n, 2, generator=g, device="cuda") * 600
        wh = torch.rand(b, n, 2, generator=g, device="cuda") * 120 + 4
    scores = ((torch.rand(b, n, generator=g, device="cuda") * 64).round() / 64).sort(dim=1, descending=True).values
    cls = torch.randint(0, NC, (b, n), generator=g, device="cuda").float()
    return torch.cat([xy, xy + wh], dim=-1).contiguous(), scores.contiguous(), cls


def phase_nms_kernels(seed: int, records: dict) -> None:
    """The fused max/argmax (K4) and the NMS (K5) against their plain versions
    on the card, bit-equal."""
    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.kernels import argmax, nms

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    # K4: the three levels of a batch-32 request in one launch, bf16 and
    # fp32, both signed-zero rules; the class slice of a concatenated map
    # (read in place) and an n that holds no 16-byte vector.
    for dtype in (torch.bfloat16, torch.float32):
        for canon in ((True, False) if dtype == torch.bfloat16 else (False,)):
            for n, pad in ((NC, 0), (NC, 64), (37, 0)):
                levels = [argmax_rows(g, (BATCH, h * w, n + pad), dtype)[..., pad:] for h, w in LEVELS]
                c = kernels.LAUNCHES["argmax"]
                gv, gi = argmax.max_argmax_levels(levels, canon_zero=canon)
                rv, ri = argmax.max_argmax_levels_plain(levels, canon_zero=canon)
                torch.cuda.synchronize()
                bits = torch.int16 if gv.dtype == torch.bfloat16 else torch.int32
                same_i, same_v = bool(torch.equal(gi, ri)), bool(torch.equal(gv.view(bits), rv.view(bits)))
                print(f"kernel argmax {dtype} levels [{BATCH},{[h * w for h, w in LEVELS]},{n}] (row stride "
                      f"{n + pad}) canon_zero={canon}: indices equal {same_i}, value bits equal {same_v}", flush=True)
                if kernels.LAUNCHES["argmax"] != c + 1 or not (same_i and same_v):
                    fail("argmax kernel disagrees with its plain version")
    records["argmax"]["max_abs_err"] = 0.0
    # K5: the keep mask and the decode's compaction at n in {1, 63, 1000,
    # 1500} (1000: the path's; 47 blocks of 32 ranks at 1500), valid masks,
    # IoUs exactly at the threshold, class-wise on and off, max_det below the
    # survivors; at 1, 8, the path's 32, 66 and 140 images a launch (a CTA
    # an image: two waves at 140). Then, at one image, n = 10,000 and 12,000
    # (past the table's 9,600 candidates: the boxes read from device
    # memory) and 2^21 (the dead bits in device memory too).
    for b in (1, 8, BATCH, 66, 140):
        for n in (1, 63, 1000, 1500) + ((10_000, 12_000) if b == 1 else ()):
            for grid, thresh in ((True, 0.5), (False, 0.45), (False, 0.65)):
                boxes, scores, cls = nms_inputs(g, b, n, grid)
                valid = torch.rand(b, n, generator=g, device="cuda") < 0.7
                for v in (valid, None):
                    got, ref = nms.nms_keep(boxes, thresh, v), nms.nms_keep_plain(boxes, thresh, v)
                    torch.cuda.synchronize()
                    if not torch.equal(got, ref):
                        fail(f"nms keep mask disagrees with its plain version: b={b} n={n} grid={grid} "
                             f"iou={thresh} valid={v is not None}")
            for class_wise in (False, True):
                for conf, iou, max_det in [(*c, MAX_DET) for c in NMS_SETTINGS.values()] + [
                        (*NMS_SETTINGS["val"], 20)]:
                    boxes, scores, cls = nms_inputs(g, b, n, False)
                    kw = dict(iou_thresh=iou, conf_thresh=conf, max_det=max_det, class_wise=class_wise)
                    gd, gn = nms.nms_compact(boxes, scores, cls, **kw)
                    rd, rn = nms.nms_compact_plain(boxes, scores, cls, **kw)
                    torch.cuda.synchronize()
                    if not (torch.equal(gd, rd) and torch.equal(gn, rn)):
                        fail(f"nms compaction disagrees with its plain version: b={b} n={n} "
                             f"class_wise={class_wise} conf={conf} iou={iou} max_det={max_det}")
        print(f"kernel nms [{b}, n] at n in (1, 63, 1000, 1500{', 10000, 12000' if b == 1 else ''}): keep masks "
              f"(grid IoUs at 0.5, spread at 0.45 and 0.65, with and without valid) and dets/num (class-wise and "
              f"not, both threshold settings at max_det 300, the validator's at 20) bit-equal to the plain version",
              flush=True)
    # 2^21 candidates, two disjoint boxes in turn, half of them valid: the
    # first valid of each survives (the plain version's n x n matrix would
    # not fit; the answer is known).
    n = 1 << 21
    pair = torch.tensor([[0.0, 0.0, 10.0, 10.0], [100.0, 100.0, 110.0, 110.0]], device="cuda")
    rank = torch.arange(n, device="cuda")
    boxes = pair[rank % 2][None].contiguous()
    valid = torch.rand(1, n, generator=g, device="cuda") < 0.5
    expect = torch.zeros(1, n, dtype=torch.bool, device="cuda")
    expect[0, [int(rank[valid[0] & (rank % 2 == p)][0]) for p in (0, 1)]] = True
    for dtype in (torch.float32, torch.bfloat16):
        got = nms.nms_keep(boxes.to(dtype), 0.5, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, expect):
            fail(f"nms keep mask at n = 2^21 ({dtype}): {int(got.sum())} survivors, not the two first valid ones")
    print("kernel nms [1, 2^21] (dead bits in device memory), fp32 and bf16: the two first valid boxes survive, "
          "nothing else", flush=True)
    records["nms"]["max_abs_err"] = 0.0


def check_nms_dets(dets, num, b: int, conf: float) -> None:
    import torch

    if tuple(dets.shape) != (b, MAX_DET, 6) or tuple(num.shape) != (b,) or num.dtype != torch.int32:
        fail(f"nms dets shape {tuple(dets.shape)}, num {tuple(num.shape)} {num.dtype}")
    if not bool(torch.isfinite(dets).all()):
        fail("non-finite NMS detections")
    rank = torch.arange(MAX_DET, device=dets.device)[None]
    kept = rank < num[:, None].long()
    if bool(dets[~kept].any()):
        fail("rows past num are not zero")
    scores, cls = dets[..., 4], dets[..., 5]
    if not bool(((scores > conf) | ~kept).all()) or not bool(((scores <= 1) | ~kept).all()):
        fail("kept scores not in (conf, 1]")
    if not bool(((scores[:, 1:] <= scores[:, :-1]) | ~kept[:, 1:]).all()):
        fail("kept scores not in descending order")
    if not bool(((cls >= 0) & (cls < NC) & (cls == cls.round())).all()):
        fail("NMS classes are not integers in [0, 80)")


def phase_nms(model, seed: int, records: dict):
    """The NMS serving path (see the module doc); returns the batch-32
    predictor and request for the timing phase."""
    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, kernels
    from leanyolo_tpu_torch.kernels import nms

    rng = np.random.RandomState(seed + 3)
    requests = {b: rng.randint(0, 256, (b, IMGSZ, IMGSZ, 3)).astype(np.uint8) for b in (1, 8, BATCH)}
    preds = {name: Predictor(model, imgsz=IMGSZ, decode="nms", dtype="bfloat16", fuse=True, max_det=MAX_DET,
                             conf_thresh=conf, iou_thresh=iou) for name, (conf, iou) in NMS_SETTINGS.items()}
    preds["class-wise"] = Predictor(model, imgsz=IMGSZ, decode="nms", dtype="bfloat16", fuse=True, max_det=MAX_DET,
                                    class_wise_nms=True)
    launches = {name: 0 for name in PER_REQUEST_NMS}
    candidates = {}  # valid candidates the NMS saw, by setting
    spy, valid_seen = nms.nms_compact, []
    nms.nms_compact = lambda b, s, c, **kw: valid_seen.append(int((s > kw["conf_thresh"]).sum(1).max())) or spy(b, s, c,
                                                                                                              **kw)
    try:
        for name, pred in preds.items():
            for b, imgs in requests.items():
                if name == "class-wise" and b != 8:
                    continue
                kernels.reset_launches()
                dets, num = pred.run_batch(imgs)
                torch.cuda.synchronize()
                got = {k: kernels.LAUNCHES[k] for k in PER_REQUEST_NMS}
                print(f"nms request ({name}) batch {b}: launches {got}; num {num.tolist()[:8]}; most valid "
                      f"candidates in an image {valid_seen[-1]}", flush=True)
                if got != PER_REQUEST_NMS:
                    fail(f"nms request batch {b} launched {got}, expected {PER_REQUEST_NMS}")
                check_nms_dets(dets, num, b, pred.conf_thresh)
                candidates[name] = max(candidates.get(name, 0), valid_seen[-1])
                if name == "infer":
                    for k, v in got.items():
                        launches[k] += v
    finally:
        nms.nms_compact = spy
    print(f"nms serving path launches over requests of batch {list(requests)} at the inference defaults: {launches}",
          flush=True)
    records["nms"]["launches"] = launches["nms"]
    records["dfl_boxes"]["launches"] = launches["dfl_boxes"]  # its path: the NMS decode (none on the top-k path)
    records["argmax"]["launches_nms"] = launches["argmax"]  # the main path (top-k) counts its "launches"
    if candidates["val"] < 1000:
        fail(f"at the validator's thresholds the NMS saw at most {candidates['val']} valid candidates, not 1000")

    # The decode on identical head maps, kernels against plain versions, at
    # batches 1, 8 and 32: bf16 maps at each setting, fp32 maps at the
    # inference defaults.
    pred32 = Predictor(model, imgsz=IMGSZ, decode="nms", dtype="float32", fuse=True, max_det=MAX_DET,
                       conf_thresh=NMS_SETTINGS["infer"][0], iou_thresh=NMS_SETTINGS["infer"][1])
    check_decodes(decode_nms_on, {**{f"bf16 {n}": p for n, p in preds.items()}, "fp32 infer": pred32},
                  torch.from_numpy(requests[BATCH]).cuda(), "nms")
    del pred32

    # fp32 on the card against fp32 on the CPU at a small input.
    small = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    kw = dict(imgsz=128, decode="nms", dtype="float32", fuse=True, conf_thresh=0.25)
    gd, gn = Predictor(model, **kw).run_batch(small)
    cd, cn = Predictor(model, device="cpu", **kw).run_batch(small)
    gd, gn = gd.cpu(), gn.cpu()
    err = max_err(gd[..., :4], cd[..., :4])
    print(f"nms fp32 card vs CPU at [2,128,128,3]: num {gn.tolist()} vs {cn.tolist()}, classes equal "
          f"{bool(torch.equal(gd[..., 5], cd[..., 5]))}, box max_abs_err {err:.6g}", flush=True)
    if not (torch.equal(gn, cn) and torch.equal(gd[..., 5], cd[..., 5]) and err <= 1e-3 * 128):
        fail("nms fp32 on the card disagrees with the CPU")
    return preds["infer"], torch.from_numpy(requests[BATCH]).cuda()


def phase_predict_images(model, seed: int) -> None:
    """predict_images on the card: eight uint8 images of mixed sizes, host
    and device letterbox, both decodes."""
    import numpy as np
    from leanyolo_tpu_torch import Predictor

    rng = np.random.RandomState(seed + 4)
    sizes = ((480, 640), (640, 480), (1080, 1920), (333, 517), (97, 1001), (640, 640), (37, 51), (1201, 799))
    imgs = [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in sizes]
    for decode in ("topk", "nms"):
        pred = Predictor(model, imgsz=IMGSZ, decode=decode, dtype="bfloat16", fuse=True, max_det=MAX_DET)
        for preprocess in ("host", "device"):
            t0 = time.perf_counter()
            out = pred.predict_images(imgs, preprocess=preprocess)
            wall = time.perf_counter() - t0
            for d, img in zip(out, imgs):
                h, w = img.shape[:2]
                if d.ndim != 2 or d.shape[1] != 6 or not np.isfinite(d).all():
                    fail(f"predict_images ({decode}, {preprocess}): bad rows {d.shape}")
                if len(d) and not ((d[:, :4] >= 0).all() and (d[:, [0, 2]] <= w).all() and (d[:, [1, 3]] <= h).all()):
                    fail(f"predict_images ({decode}, {preprocess}): a box leaves its {h}x{w} image")
            print(f"predict_images {decode} {preprocess}: boxes per image {[len(d) for d in out]}, all inside their "
                  f"images; {wall:.3f} s for 8 images", flush=True)
    # Host against device letterbox, held as the JAX package holds them
    # (tests/test_device_preprocess.py): fp32, top-k, every row, equal
    # shapes and scores within 5e-3.
    pred = Predictor(model, imgsz=IMGSZ, decode="topk", dtype="float32", fuse=True, conf_thresh=0.0)
    host = pred.predict_images(imgs, apply_conf_filter=False)
    dev = pred.predict_images(imgs, apply_conf_filter=False, preprocess="device")
    worst = max(float(np.abs(h[:, 4] - d[:, 4]).max()) for h, d in zip(host, dev))
    print(f"predict_images fp32 top-k, host vs device letterbox: shapes equal "
          f"{all(h.shape == d.shape for h, d in zip(host, dev))}, worst score gap {worst:.6g} (limit 5e-3)", flush=True)
    if not (all(h.shape == d.shape for h, d in zip(host, dev)) and worst <= 5e-3):
        fail("predict_images: host and device letterboxing disagree")


def phase_nms_times(seed: int, records: dict, pred, x32) -> None:
    """K4, K3 (NMS mode) and K5 at the path's shapes, and the NMS request's
    step time."""
    import torch
    from leanyolo_tpu_torch.kernels import _build, argmax, bounds, dfl, nms, topk

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    bf = torch.bfloat16
    # K4 on the three levels' cls maps of a batch-32 request (the one2many
    # head's, bf16), one launch, the path's fp32 rule; torch.max per level.
    maps = pred.raw(x32)
    levels = [c.reshape(BATCH, -1, NC) for _, c in maps]
    r = records["argmax"]
    r["ms"] = events_ms(lambda: argmax.max_argmax_levels(levels, canon_zero=False), inner=KERNEL_INNER)
    r["device_ms"] = device_ms(lambda: argmax.max_argmax_levels(levels, canon_zero=False))
    r["plain_ms"] = events_ms(lambda: argmax.max_argmax_levels_plain(levels, canon_zero=False), inner=KERNEL_INNER)
    r["library_ms"] = events_ms(lambda: [torch.max(c, dim=-1) for c in levels], inner=KERNEL_INNER)
    set_bound(r, *bounds.argmax_work(BATCH * sum(c.shape[1] for c in levels), NC), "fp32")
    per_level = [events_ms(lambda: argmax.max_argmax_levels([c], canon_zero=False), inner=KERNEL_INNER)
                 for c in levels]
    print(f"argmax levels {[list(c.shape) for c in levels]} bf16, one launch: kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f}, torch.max x3 {r['library_ms']:.4f}, bound "
          f"{r['bound_ms']:.6f} ({r['bound_by']}); a launch per level {[round(t, 4) for t in per_level]}", flush=True)
    # The same launch with the non-finite flags, as both decodes run it: the
    # reg maps read too, the flags zeroed by a memset first.
    regs = [r_.reshape(BATCH, -1, r_.shape[-1]) for r_, _ in maps]
    call = lambda: argmax.max_argmax_flags(levels, regs, canon_zero=False)  # noqa: E731
    t = {"ms": events_ms(call, inner=KERNEL_INNER), "device_ms": device_ms(call), "host_us": host_us(call, n=200),
         "plain_ms": events_ms(lambda: argmax.max_argmax_flags_plain(levels, regs, canon_zero=False),
                             inner=KERNEL_INNER)}
    set_bound(t, *bounds.argmax_flags_work(BATCH, sum(c.shape[1] for c in levels), NC), "fp32")
    r["flags"] = t
    print(f"argmax with the non-finite flags (the class and reg maps of the three levels), one launch and a memset: "
          f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}), host {t['host_us']:.2f} us a call, plain "
          f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.6f} ({t['bound_by']})", flush=True)

    # K3 in NMS mode on the [32, 1000] candidates of the batch-32 request:
    # with the flags (the live NMS decode) and without (the export).
    with check_time(DECODE_CHECK_S, "K3 NMS mode timed"):
        hw = [tuple(c.shape[1:3]) for _, c in maps]
        best, _, flags = argmax.max_argmax_flags(levels, regs, canon_zero=False)
        _, anc = topk.topk(best, 1000, canon_zero=False)
        for name, fl in (("flags", flags), ("no flags", None)):
            call = lambda: dfl.dfl_boxes(regs, hw, STRIDES, anc, flags=fl)  # noqa: E731
            t = {"ms": events_ms(call, inner=KERNEL_INNER), "device_ms": device_ms(call),
                 "host_us": host_us(call, n=200),
                 "plain_ms": events_ms(lambda: dfl.dfl_boxes_plain(regs, hw, STRIDES, anc, flags=fl),
                                     inner=KERNEL_INNER)}
            set_bound(t, *bounds.dfl_boxes_work(BATCH, 1000, regs[0].element_size(), flags=fl is not None), "fp32")
            if fl is not None:
                records["dfl_boxes"].update(t, library_ms=None)
            else:
                records["dfl_boxes"]["no_flags"] = t
            print(f"dfl_boxes NMS mode [{BATCH},1000] bf16 reg rows -> [{BATCH},1000,4], {name}: kernel "
                  f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}), host {t['host_us']:.2f} us a call, plain "
                  f"{t['plain_ms']:.4f}, library none, bound {t['bound_ms']:.6f} ({t['bound_by']})", flush=True)

    # K5 on the candidates of a batch-32 request under each threshold setting.
    from leanyolo_tpu_torch.models.yolov10.decode import decode_nms

    for name, (conf, iou) in NMS_SETTINGS.items():
        seen, spy = [], nms.nms_compact
        nms.nms_compact = lambda *a, **kw: seen.append((a, kw)) or spy(*a, **kw)
        try:
            decode_nms(maps, num_classes=NC, conf_thresh=conf, iou_thresh=iou, max_det=MAX_DET,
                       rank_dtype=torch.float32)
        finally:
            nms.nms_compact = spy
        (boxes, scores, cls), kw = seen[0]
        # The path's [32, 1000] candidates, kernel against plain version
        # (keep mask, dets and num), class-wise and not.
        valid = scores > nms.f32(conf)
        keep = nms.nms_keep(boxes, iou, valid)
        same = bool(torch.equal(keep, nms.nms_keep_plain(boxes, iou, valid)))
        for class_wise in (False, True):
            kwc = dict(kw, class_wise=class_wise)
            gd, gn = nms.nms_compact(boxes, scores, cls, **kwc)
            rd, rn = nms.nms_compact_plain(boxes, scores, cls, **kwc)
            same = same and bool(torch.equal(gd, rd) and torch.equal(gn, rn))
        print(f"kernel nms on the path's candidates [{BATCH},{boxes.shape[1]}] conf {conf} iou {iou}: keep mask and "
              f"dets/num (class-wise and not) bit-equal to the plain version {same}", flush=True)
        if not same:
            fail(f"nms kernel disagrees with its plain version on the path's batch-{BATCH} candidates")
        n = boxes.shape[1]
        ext, off = _build.ext(), nms.f32(kw["group_offset"])
        for b in (BATCH, 1):
            bx, sc, cl = (t[:b].contiguous() for t in (boxes, scores, cls))
            evaluated, needed = bounds.nms_pairs(bx, iou, sc > nms.f32(conf), k_out=min(MAX_DET, n))
            nbytes, nops = bounds.nms_work(b, n, MAX_DET, needed)
            call = lambda: nms.nms_compact(bx, sc, cl, **kw)  # noqa: E731
            direct = lambda: ext.nms(bx, sc, cl, None, nms.f32(iou), True, nms.f32(conf),  # noqa: E731
                                     kw["class_wise"], off, False, kw["max_det"])
            # Device time at the path's batch; batch 1 by CUDA events.
            t = {"ms": events_ms(call, inner=KERNEL_INNER), **({"device_ms": device_ms(call)} if b == BATCH else {}),
                 "plain_ms": events_ms(lambda: nms.nms_compact_plain(bx, sc, cl, **kw), warmup=1, runs=3),
                 "host_us": host_us(call, n=200), "host_us_direct": host_us(direct, n=200),
                 "pairs_evaluated": evaluated, "pairs_needed": needed}
            set_bound(t, nbytes, nops, "fp32")
            device = f" (device {t['device_ms']:.4f})" if b == BATCH else ""
            print(f"nms [{b},{n}] conf {conf} iou {iou} ({int(keep[:b].sum())} survivors; pairs evaluated {evaluated}, "
                  f"needed {needed}, the slice-7 kernel's {b * n * (n - 1) // 2}): kernel {t['ms']:.4f} ms{device}, "
                  f"host {t['host_us']:.2f} us a call through the operator, {t['host_us_direct']:.2f} direct; plain "
                  f"{t['plain_ms']:.4f}, library none, bound {t['bound_ms']:.6f} ({t['bound_by']}; the chain of "
                  f"settles is outside it)", flush=True)
            if name == "infer" and b == BATCH:
                records["nms"].update(t, library_ms=None)
            else:
                records["nms"][f"{name}_batch{b}" if b == 1 else "val_thresholds"] = t
    print(f"nms: the slice-7 kernel's split at the path's candidates, as slice 14's first chip run measured it: "
          f"{SLICE7_NMS_SPLIT}", flush=True)

    # The NMS request: batch 32 and batch 1, one request from an idle card.
    x1 = x32[:1].contiguous()
    for b, x in ((BATCH, x32), (1, x1)):
        ms = events_ms(lambda: pred.run_batch(x), warmup=3, runs=20)
        print(f"nms serving path yolov10s 640 bf16 batch {b}: ms/request {ms:.4f}, img/s {b / ms * 1e3:.2f} "
              f"(uint8 batch already on the card)", flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            pred.run_batch(x32)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in events)
    print(f"nms profile, 5 requests at batch {BATCH}: device time {total / 5 / 1e3:.4f} ms/request; top kernels:",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 5 / 1e3:9.4f} ms/request {e.count // 5:5d} calls  {e.key[:90]}",
              flush=True)
    for name, tag in (("argmax", "argmax_kernel"), ("nms", "nms_kernel"), ("topk", "topk_kernel"),
                      ("dfl_boxes", "dfl_boxes_kernel")):
        es = [e for e in events if tag in e.key]
        print(f"nms profile: {name} kernels {sum(e.self_device_time_total for e in es) / 5 / 1e3:.4f} ms/request in "
              f"{sum(e.count for e in es) // 5} calls", flush=True)


RELEASE_MODULE = "ultralytics.nn.tasks"  # the class module a release file names; not installed here


def release_state_dict(model, fused: bool) -> dict:
    """`model`'s state as a THU-MIG release file's flat state dict: the
    port's keymap inverted (`model.{idx}.` keys), fp16 tensors, a step
    counter beside every BN, no input norms. `fused` writes each RepVGGDW as
    release files do: both branches BN-folded and summed into one 7x7 conv
    (`cv1.2.conv.weight`) with an identity-like BN carrying the bias
    (`cv1.2.bn.*`), `conv1` dropped."""
    import torch
    import torch.nn.functional as F
    from leanyolo_tpu_torch.models.yolov10.keymap import BACKBONE_MAP, HEAD_MAP, NECK_MAP
    from leanyolo_tpu_torch.models.yolov10.layers import BN_EPS
    from leanyolo_tpu_torch.models.yolov10.remap import params_to_torch_sd

    inv = {lean: idx for table in (BACKBONE_MAP, NECK_MAP, HEAD_MAP) for idx, lean in table.items()}
    sd = {}
    for k, v in params_to_torch_sd(model).items():
        prefix = next((p for p in inv if k.startswith(p + ".")), None)
        if prefix is not None:
            key = f"model.{inv[prefix]}.{k[len(prefix) + 1:]}"
            sd[key] = v.half()
            if key.endswith(".bn.running_var"):
                sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    if not fused:
        return sd
    for base in sorted(k[: -len(".conv.conv.weight")] for k in sd if k.endswith(".cv1.2.conv.conv.weight")):
        w_sum = b_sum = 0.0
        for branch, pad in (("conv", 0), ("conv1", 2)):
            w = sd.pop(f"{base}.{branch}.conv.weight").float()
            g, b, m, v = (sd.pop(f"{base}.{branch}.bn.{n}").float()
                          for n in ("weight", "bias", "running_mean", "running_var"))
            sd.pop(f"{base}.{branch}.bn.num_batches_tracked")
            mul = g / torch.sqrt(v + BN_EPS)
            w_sum = w_sum + F.pad(w * mul[:, None, None, None], (pad,) * 4)
            b_sum = b_sum + (b - m * mul)  # fold.py's sums, in its order
        c = w_sum.shape[0]
        sd[f"{base}.conv.weight"] = w_sum.half()
        sd.update({f"{base}.bn.weight": torch.ones(c).half(), f"{base}.bn.bias": b_sum.half(),
                   f"{base}.bn.running_mean": torch.zeros(c).half(),
                   f"{base}.bn.running_var": torch.full((c,), 1.0 - BN_EPS).half(),
                   f"{base}.bn.num_batches_tracked": torch.tensor(0)})
    return sd


def write_release_file(sd: dict, path: str) -> None:
    """torch.save `sd` as a release file holds it: {"model": <a pickled
    DetectionModel of RELEASE_MODULE>, ...}, the tensors in each node's
    `_parameters`/`_buffers`. The module is put in sys.modules for the save
    and taken out again, so the reader has to stub it."""
    import types

    import torch

    class DetectionModel:
        pass

    DetectionModel.__module__, DetectionModel.__qualname__ = RELEASE_MODULE, "YOLOv10DetectionModel"
    names = ("ultralytics", "ultralytics.nn", RELEASE_MODULE)
    for name in names:
        sys.modules.setdefault(name, types.ModuleType(name))
    setattr(sys.modules[RELEASE_MODULE], "YOLOv10DetectionModel", DetectionModel)

    def node():
        o = DetectionModel()
        o.__dict__.update(_parameters={}, _buffers={}, _modules={})
        return o

    root = node()
    for key, t in sd.items():
        *parents, leaf = key.split(".")
        cur = root
        for p in parents:
            if p not in cur._modules:
                cur._modules[p] = node()
            cur = cur._modules[p]
        slot = cur._buffers if leaf in ("running_mean", "running_var", "num_batches_tracked") else cur._parameters
        slot[leaf] = t
    try:
        torch.save({"model": root, "epoch": -1, "train_args": {"data": "coco.yaml"}}, path)
    finally:
        for name in names:
            sys.modules.pop(name, None)


def load_pretrained_or_fail(name: str):
    """get_model(weights="PRETRAINED_COCO") with its warnings read: the
    random-init fallback, a missing leaf or less than full coverage fail the
    run. Returns (model, the coverage line, wall seconds)."""
    import warnings

    from leanyolo_tpu_torch import get_model

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = get_model(name, weights="PRETRAINED_COCO", class_names=[f"c{i}" for i in range(NC)])
    wall = time.perf_counter() - t0
    msgs = [str(w.message) for w in caught]
    cover = [m for m in msgs if "filled model:" in m]
    if any("Proceeding with randomly initialized" in m or "Missing leaves" in m for m in msgs):
        fail(f"get_model(PRETRAINED_COCO) fell back or missed leaves: {msgs}")
    if len(cover) != 1 or not cover[0].endswith("leaves (100.0%)."):
        fail(f"get_model(PRETRAINED_COCO) did not fill the model: {msgs}")
    return model, cover[0], wall


def phase_weights(model, seed: int, card: str) -> None:
    """Official-format weights loaded and served on the card (item 9 of the module doc)."""
    import copy
    import importlib.util
    import tempfile
    from unittest import mock

    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, get_model, kernels
    from leanyolo_tpu_torch.models.registry import load_checkpoint_meta, save_checkpoint
    from leanyolo_tpu_torch.models.yolov10.fold import fold_model
    from leanyolo_tpu_torch.models.yolov10.layers import FusedRepVGGDW

    if importlib.util.find_spec("ultralytics") is not None:
        fail("ultralytics is installed: the release file's class would not need a stub")
    # The source module with every released tensor rounded to fp16, as the
    # unfused file holds it: the model it loads must equal this one exactly.
    src16 = copy.deepcopy(model)
    src16.load_state_dict({k: v if k.startswith("input_") else v.half().float()
                           for k, v in model.state_dict().items()})
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(os.environ, {"LEANYOLO_WEIGHTS_DIR": tmp}):
        path = os.path.join(tmp, "yolov10s.pt")
        write_release_file(release_state_dict(model, fused=False), path)
        loaded, cover, load_s = load_pretrained_or_fail("yolov10s")
        print(f"weights: unfused release file ({os.path.getsize(path) / 2**20:.1f} MiB, fp16) loaded by "
              f"get_model(PRETRAINED_COCO) in {load_s:.3f} s wall: {cover}", flush=True)
        got = loaded.state_dict()
        if not all(torch.equal(got[k], v) for k, v in src16.state_dict().items()):
            fail("weights: the loaded state differs from the source module's fp16-rounded state")
        write_release_file(release_state_dict(model, fused=True), path)
        loaded_fused, cover_fused, _ = load_pretrained_or_fail("yolov10s")
        print(f"weights: fused-RepVGGDW release file: {cover_fused}", flush=True)

        npz = os.path.join(tmp, "ckpt.npz")
        save_checkpoint(loaded, npz, extra_meta={"epoch": 1})
        again = get_model("yolov10s", weights=npz, class_names=[f"c{i}" for i in range(NC)], seed=seed + 6)
        meta = load_checkpoint_meta(npz)
    same = all(torch.equal(again.state_dict()[k], v) for k, v in loaded.state_dict().items())
    print(f"weights: .npz save_checkpoint -> get_model(weights=file): state bit-equal {same}; meta "
          f"{ {k: meta[k] for k in ('model_name', 'leanyolo_version', 'epoch')} }", flush=True)
    if not same or meta["model_name"] != "yolov10s" or meta["epoch"] != 1:
        fail("weights: the .npz round trip changed the model")

    # Serve the loaded model at the path's batch against the source module,
    # cuDNN deterministic on both sides.
    rng = np.random.RandomState(seed + 5)
    x32 = torch.from_numpy(rng.randint(0, 256, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.uint8)).cuda()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        pred = Predictor(loaded, imgsz=IMGSZ, decode="topk", dtype="bfloat16", fuse=True, max_det=MAX_DET)
        ref = Predictor(src16, imgsz=IMGSZ, decode="topk", dtype="bfloat16", fuse=True, max_det=MAX_DET)
        kernels.reset_launches()
        dets, num = pred.run_batch(x32)
        torch.cuda.synchronize()
        got = {name: kernels.LAUNCHES[name] for name in PER_REQUEST}
        routes = {name: kernels.LAUNCHES[name] for name in NEW_ROUTES}
        print(f"weights: request batch {BATCH} through the loaded model: launches {got}, on the bf16 routes "
              f"{routes}", flush=True)
        if got != PER_REQUEST or any(routes[n] != PER_REQUEST[of] for n, of in NEW_ROUTES.items()):
            fail(f"weights: the loaded model's request launched {got} ({routes}), expected {PER_REQUEST}")
        check_dets(dets, num, BATCH)
        want_dets, want_num = ref.run_batch(x32)
        maps, want_maps = pred.raw(x32), ref.raw(x32)
        torch.cuda.synchronize()
        same_maps = all(torch.equal(a, b) for lvl, w_lvl in zip(maps, want_maps) for a, b in zip(lvl, w_lvl))
        same_dets = torch.equal(dets, want_dets) and torch.equal(num, want_num)
        print(f"weights: loaded vs source module, batch {BATCH} bf16 folded: detections bit-equal {same_dets}, "
              f"head maps bit-equal {same_maps}", flush=True)
        if not (same_maps and same_dets):
            fail("weights: the model loaded from the unfused file does not serve as the source module does")
        del ref, maps, want_maps

        # The fused file rounds each RepVGGDW's merged kernel and bias to
        # fp16: the source module folded, with those two rounded, is what it
        # holds (up to its identity-like BN's fp16 variance).
        ref = fold_model(src16)
        state = ref.state_dict()
        for name, m in ref.named_modules():
            if isinstance(m, FusedRepVGGDW):
                for k in (f"{name}.conv.weight", f"{name}.conv.bias"):
                    state[k] = state[k].half().float()
        ref.load_state_dict(state)  # packs the dw7x7 weights again
        x8 = x32[:8]
        fused32 = Predictor(loaded_fused, imgsz=IMGSZ, dtype="float32", fuse=True).raw(x8)
        src32 = Predictor(ref, imgsz=IMGSZ, dtype="float32", fuse=True).raw(x8)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    # Timed with cuDNN's usual algorithms, as the serving phase times the path;
    # the device time tells the card's share from the host's.
    request_ms = events_ms(lambda: pred.run_batch(x32))
    request_device_ms = device_ms(lambda: pred.run_batch(x32), reps=5)
    del pred
    for lvl, (f_lvl, s_lvl) in enumerate(zip(fused32, src32)):
        for name, a, b in zip(("reg", "cls"), f_lvl, s_lvl):
            err, scale = max_err(a, b), float(b.abs().max())
            print(f"weights: fused file vs source module, fp32 head P{lvl + 3} {name} at batch 8: max_abs_err "
                  f"{err:.6g} of scale {scale:.6g}", flush=True)
            if not err <= 1e-3 * max(1.0, scale):
                fail("weights: the model loaded from the fused file disagrees with the source module")
    print(f"weights: load {load_s:.3f} s wall (host: read, remap, load); request batch {BATCH} through the loaded "
          f"model {request_ms:.4f} ms (CUDA events, median of 20, one request from an idle card), device "
          f"{request_device_ms:.4f} ms (profiler, 5 requests); {card}", flush=True)


# COCO 2017's 80 category ids (1..90 without ten), class i being the i-th.
COCO_CAT_IDS = tuple(i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
VAL_IMAGES = 64
# (w, h): COCO-like sizes, and a small one, letterboxed at gain 4, whose
# labels fall under 32^2 px in the image's own pixels, so COCO's small area
# range is scored.
VAL_SIZES = ((640, 480), (480, 640), (640, 427), (500, 375), (160, 120))
VAL_BATCH = 32
# The validation model is make_model's calibrated again on the set's
# images: each BN's variance taken 8x what it sees, so activations shrink
# by 2.8x a BN and bf16 rounding noise does not grow layer by layer as it
# does at unit scale (where bf16 loses most of the fp32 labels); and the
# class logits spread to mean -4, std 1, so that scores separate the
# detections (random weights alone put the top scores at 1.0 in fp32).
VAL_VAR_SCALE = 8.0
VAL_LOGITS = (-4.0, 1.0)
VAL_LABELS = 10  # labels an image


def write_val_set(root: str, seed: int):
    """VAL_IMAGES JPEGs (PIL) of noise with 2-6 filled rectangles at the
    VAL_SIZES in turn, under root/images; returns (images dir, COCO image entries),
    with ids that are neither contiguous nor 1-based."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    images_dir = os.path.join(root, "images")
    os.makedirs(images_dir)
    entries = []
    for i in range(VAL_IMAGES):
        w, h = VAL_SIZES[i % len(VAL_SIZES)]
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for _ in range(rng.randint(2, 7)):
            x0, y0 = rng.randint(0, w - 32), rng.randint(0, h - 32)
            x1, y1 = rng.randint(x0 + 16, w + 1), rng.randint(y0 + 16, h + 1)
            img[y0:y1, x0:x1] = rng.randint(0, 256, 3)
        image_id = 139 + 53 * i
        name = f"{image_id:012d}.jpg"
        Image.fromarray(img).save(os.path.join(images_dir, name), quality=90)
        entries.append({"id": image_id, "file_name": name, "width": w, "height": h})
    return images_dir, entries


def self_label(dets: list, entries: list):
    """COCO annotations from per-image detections ([N, 6] xyxy, score, class
    in original pixels, all that the top-k decode keeps, in rank order): in
    each image its VAL_LABELS best-ranked detections at least 2 px wide and
    high (its threshold: the last one's score). The random net's score level
    differs from image to image by more than the spread within one (the
    thresholds printed span most of (0, 1]), so one threshold for all would
    put nearly every label on a few images, and an image's unlabelled
    detections can outscore other images' labels: where
    one scores at least the lowest label of its category, a crowd region
    over the whole image for that category makes it ignored, not a false
    positive. A predictor that finds its own labels scores an mAP of 1; a
    wrong box, class, image id or unletterbox loses labels. Returns
    (annotations, per-image thresholds)."""
    import numpy as np

    picked = []
    for d in dets:
        big = np.flatnonzero(((d[:, 2] - d[:, 0]) >= 2) & ((d[:, 3] - d[:, 1]) >= 2))
        p = np.zeros(len(d), bool)
        p[big[np.argsort(-d[big, 4], kind="stable")[:VAL_LABELS]]] = True
        picked.append(p)
    lowest = {}
    for d, p in zip(dets, picked):
        for score, cls in d[p][:, 4:6].tolist():
            lowest[int(cls)] = min(score, lowest.get(int(cls), np.inf))
    anns = []

    def add(image_id, cls, bbox, iscrowd):
        anns.append({"id": len(anns) + 1, "image_id": image_id, "category_id": COCO_CAT_IDS[cls], "bbox": bbox,
                     "area": bbox[2] * bbox[3], "iscrowd": iscrowd})

    for d, p, e in zip(dets, picked, entries):
        for x1, y1, x2, y2, _, cls in d[p].tolist():
            add(e["id"], int(cls), [x1, y1, x2 - x1, y2 - y1], 0)
        for cls in sorted({int(c) for score, c in d[~p][:, 4:6].tolist() if score >= lowest.get(int(c), np.inf)}):
            add(e["id"], cls, [0.0, 0.0, float(e["width"]), float(e["height"])], 1)
    return anns, [float(d[p, 4].min()) for d, p in zip(dets, picked)]


def val_reference(pred, ds, preprocess: str):
    """The detections of `pred` on the set's batches, as validate_coco batches
    them (host: the loader's letterboxed batches through run_batch; device:
    the canvases through run_canvas), in COCO columns."""
    import numpy as np
    from leanyolo_tpu_torch.data.dataset import DataLoader
    from leanyolo_tpu_torch.engine.validator import detections_to_coco_arrays
    from leanyolo_tpu_torch.ops.letterbox import canvas_batch, dataset_canvas_size

    keys = ("image_id", "gain", "pad", "orig_hw")
    outs = []
    if preprocess == "host":
        for batch in DataLoader(ds, batch_size=VAL_BATCH, workers=8, max_boxes=1):
            metas = [None if m is None else {k: m[k] for k in keys} for m in batch.meta]
            outs.append((*pred.run_batch(batch.images), metas))
    else:
        size = dataset_canvas_size(ds.images, IMGSZ)
        for s in range(0, len(ds), VAL_BATCH):
            canvas, new_hw, pads, hw, cm = canvas_batch([ds.load_image(i) for i in range(s, s + VAL_BATCH)], IMGSZ,
                                                        canvas_size=size)
            metas = [dict(zip(keys, (ds.images[s + i]["id"], *cm[i]))) for i in range(VAL_BATCH)]
            outs.append((*pred.run_canvas(canvas, new_hw, pads, hw), metas))
    cols = [detections_to_coco_arrays(d.cpu().numpy(), n.cpu().numpy(), m, ds.cat_ids, decode=pred.decode)
            for d, n, m in outs]
    return [np.concatenate([c[k] for c in cols]) for k in range(4)]


def labelled_val_set(model, seed: int, tmp: str):
    """The validation set of item 10 under tmp (write_val_set), labelled by
    its own fp32 folded predictor (self_label): make_model's model,
    calibrated again on the set's letterboxed images (VAL_VAR_SCALE,
    VAL_LOGITS), saved to a .npz and loaded back as a user loads one.
    Returns (images dir, entries, annotations file, labels-only file,
    annotations, per-image thresholds, .npz path, loaded model, fp32 folded
    predictor)."""
    import copy

    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, get_model
    from leanyolo_tpu_torch.data.coco import coco80_class_names
    from leanyolo_tpu_torch.data.dataset import CocoDetection
    from leanyolo_tpu_torch.models.registry import save_checkpoint
    from leanyolo_tpu_torch.ops.letterbox import letterbox

    images_dir, entries = write_val_set(tmp, seed + 7)
    cats = [{"id": c, "name": n} for c, n in zip(COCO_CAT_IDS, coco80_class_names())]
    blank = os.path.join(tmp, "blank.json")
    with open(blank, "w") as f:
        json.dump({"images": entries, "annotations": [], "categories": cats}, f)
    ds = CocoDetection(images_dir, blank, img_size=IMGSZ)
    raw = [ds.load_image(i) for i in range(len(ds))]

    lb = torch.from_numpy(np.stack([letterbox(im, IMGSZ)[0] for im in raw])).cuda()
    vmodel = calibrate(copy.deepcopy(model).cuda(), lb, logits=VAL_LOGITS, var_scale=VAL_VAR_SCALE)
    del lb
    npz = os.path.join(tmp, "yolov10s_val.npz")
    save_checkpoint(vmodel, npz)
    loaded = get_model("yolov10s", weights=npz, class_names=coco80_class_names())

    # Self-labelling: the fp32 folded predictor's detections (host letterbox).
    pred32 = Predictor(loaded, imgsz=IMGSZ, decode="topk", dtype="float32", fuse=True, max_det=MAX_DET)
    dets = []
    for s in range(0, VAL_IMAGES, VAL_BATCH):
        dets += pred32.predict_images(raw[s:s + VAL_BATCH], apply_conf_filter=False)
    anns, thrs = self_label(dets, entries)
    ann, ann_plain = os.path.join(tmp, "annotations.json"), os.path.join(tmp, "labels_only.json")
    for path, a in ((ann, anns), (ann_plain, [a for a in anns if not a["iscrowd"]])):
        with open(path, "w") as f:
            json.dump({"images": entries, "annotations": a, "categories": cats}, f)
    return images_dir, entries, ann, ann_plain, anns, thrs, npz, loaded, pred32


def phase_validation(model, seed: int, card: str) -> None:
    """COCO validation on the card (item 10 of the module doc)."""
    import csv
    import tempfile

    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, kernels
    from leanyolo_tpu_torch.data.dataset import CocoDetection, DataLoader
    from leanyolo_tpu_torch.engine.validator import measure_fps, validate_coco
    from leanyolo_tpu_torch.utils.coco_eval import CocoEvaluator

    n_batches = VAL_IMAGES // VAL_BATCH  # whole batches: val_reference pads none
    with tempfile.TemporaryDirectory() as tmp:
        images_dir, entries, ann, ann_plain, anns, thrs, npz, loaded, pred32 = labelled_val_set(model, seed, tmp)
        labels = [a for a in anns if not a["iscrowd"]]
        n_small = sum(a["area"] < 32**2 for a in labels)
        if not n_small:
            fail("validation: no label falls in COCO's small area range")
        print(f"validation set: {VAL_IMAGES} JPEG images ({', '.join(f'{w}x{h}' for w, h in VAL_SIZES)}), "
              f"80 COCO categories; labelled by the fp32 folded predictor (predict_images, host letterbox): "
              f"{len(labels)} labels in {len({a['category_id'] for a in labels})} categories, each image its "
              f"{VAL_LABELS} best-ranked detections of 2 px or more (thresholds {min(thrs)!r} to "
              f"{max(thrs)!r}, median {float(np.median(thrs))!r}), {n_small} of them under 32^2 px, plus "
              f"{len(anns) - len(labels)} crowd regions", flush=True)

        predb = Predictor(loaded, imgsz=IMGSZ, decode="topk", dtype="bfloat16", fuse=True, max_det=MAX_DET)
        predn = Predictor(loaded, imgsz=IMGSZ, decode="nms", conf_thresh=NMS_SETTINGS["val"][0],
                          iou_thresh=NMS_SETTINGS["val"][1], dtype="bfloat16", fuse=True, max_det=MAX_DET)
        ds = CocoDetection(images_dir, ann, img_size=IMGSZ)
        runs = (("fp32 top-k host", pred32, "host", PER_REQUEST), ("bf16 top-k host", predb, "host", PER_REQUEST),
                ("bf16 top-k device", predb, "device", PER_REQUEST),
                ("bf16 nms host", predn, "host", PER_REQUEST_NMS))
        stats, saved_at = {}, {}
        for label, pred, preprocess, per_batch in runs:
            path = saved_at[label] = os.path.join(tmp, f"dets_{len(saved_at)}.json")
            kernels.reset_launches()
            st = validate_coco(loaded, images_dir=images_dir, ann_json=ann, imgsz=IMGSZ, batch_size=VAL_BATCH,
                               decode=pred.decode, workers=8, save_detections=path, predictor=pred,
                               preprocess=preprocess)
            torch.cuda.synchronize()
            got = {name: kernels.LAUNCHES[name] for name in per_batch}
            routes = {name: kernels.LAUNCHES[name] for name in NEW_ROUTES}
            want = {name: n * n_batches for name, n in per_batch.items()}
            if st["n_images"] != VAL_IMAGES:
                fail(f"validation {label}: {st['n_images']} images scored, not {VAL_IMAGES}")
            if got != want:
                fail(f"validation {label}: launched {got}, expected {want} ({n_batches} batches)")
            if pred.dtype == torch.bfloat16 and any(routes[r] != want[of] for r, of in NEW_ROUTES.items()):
                fail(f"validation {label}: bf16 routes launched {routes}")
            # The validator adds no error: its saved detections are what
            # run_batch (run_canvas) gives on the same batches.
            with open(path) as f:
                saved = json.load(f)
            ref = val_reference(pred, ds, preprocess)
            cols = (np.asarray([r["image_id"] for r in saved], np.int64),
                    np.asarray([r["category_id"] for r in saved], np.int64),
                    np.asarray([r["bbox"] for r in saved], np.float64).reshape(-1, 4),
                    np.asarray([r["score"] for r in saved], np.float64))
            same = all(a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)) for a, b in zip(cols, ref))
            if not same:
                gap = max(float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
                          for a, b in zip(cols[2:], ref[2:]))
                fail(f"validation {label}: saved detections differ from run_batch's on the same batches "
                     f"(largest box/score gap {gap})")
            # Scoring the saved file in a fresh evaluator gives the same stats.
            t0 = time.perf_counter()
            ev = CocoEvaluator(ann)
            ev.add_detections(saved)
            again = ev.evaluate()
            eval_s = time.perf_counter() - t0
            if any(again[k] != st[k] for k in again):
                fail(f"validation {label}: the saved detections score {again}, the run {st}")
            stats[label] = dict(st, eval_s=eval_s)
            print(f"validation {label}: {json.dumps({k: st[k] for k in again})}; {st['wall_s']:.4f} s wall, "
                  f"{st['throughput_ips']:.2f} img/s (host clock, {VAL_IMAGES} images, batch {VAL_BATCH}); "
                  f"launches {got}; {len(saved)} detections bit-equal to run_batch's, re-scored equal; {card}",
                  flush=True)

        # At least 0.99 rather than 1.0: the labels' boxes are unletterboxed by
        # predict_images and written as xywh in the JSON's doubles, the
        # detections' by the validator in fp32 columns, so their last bits
        # may differ (1.0 where they do not).
        fp32 = stats["fp32 top-k host"]["map_50_95"]
        print(f"validation fp32 top-k on its own labels: map_50_95 {fp32!r} (at least 0.99)", flush=True)
        if not fp32 >= 0.99:
            fail("validation: the fp32 folded predictor does not find its own labels")
        host, dev = stats["bf16 top-k host"]["map_50_95"], stats["bf16 top-k device"]["map_50_95"]
        print(f"validation bf16 top-k, host vs device letterbox: map_50_95 {host!r} vs {dev!r} (limit 2e-2)",
              flush=True)
        if not abs(host - dev) <= 2e-2:
            fail("validation: host and device letterboxing disagree on the mAP")
        # Where the bf16 loss against the fp32 labels comes from: the same bf16
        # folded predictor with every kernel swapped for its plain version.
        # The kernels may move the mAP no further from the plain bf16 run's
        # than bf16 rounding itself moves it from the fp32 run's (check_paths'
        # rule for the head maps, read at the end of the pipeline).
        kernels.reset_launches()
        with plain_kernels():
            plain = validate_coco(loaded, images_dir=images_dir, ann_json=ann, imgsz=IMGSZ, batch_size=VAL_BATCH,
                                  workers=8, predictor=predb)
        torch.cuda.synchronize()
        if any(kernels.LAUNCHES.values()) or plain["n_images"] != VAL_IMAGES:
            fail(f"validation plain bf16: launches {dict(kernels.LAUNCHES)}, {plain['n_images']} images")
        gap, rounding = abs(host - plain["map_50_95"]), abs(fp32 - plain["map_50_95"])
        print(f"validation bf16 top-k host, plain (every kernel swapped for its plain version): "
              f"{json.dumps({k: plain[k] for k in again})}; map_50_95 kernels {host!r} vs plain "
              f"{plain['map_50_95']!r}, gap {gap!r} (limit: plain bf16's own loss from fp32, {rounding!r})",
              flush=True)
        if not gap <= rounding:
            fail("validation: the bf16 kernels move the mAP further than bf16 rounding does")

        # Where a run's wall time goes (the main path's configuration): the
        # host's loader (decode + letterbox, 8 threads) and evaluator alone,
        # and the device's busy time in a profiled run.
        t0 = time.perf_counter()
        for _ in DataLoader(ds, batch_size=VAL_BATCH, workers=8, max_boxes=1):
            pass
        load_s = time.perf_counter() - t0
        prof_st, busy_ms = profiled(lambda: validate_coco(loaded, images_dir=images_dir, ann_json=ann, imgsz=IMGSZ,
                                                          batch_size=VAL_BATCH, workers=8, predictor=predb))
        busy_s = busy_ms / 1e3
        main = stats["bf16 top-k host"]
        with open(saved_at["bf16 top-k host"]) as f:
            saved = json.load(f)
        t0 = time.perf_counter()
        ev = CocoEvaluator(ann_plain)
        ev.add_detections(saved)
        ev.evaluate()
        eval_plain_s = time.perf_counter() - t0
        print(f"validation bf16 top-k host, where the wall time goes: run {main['wall_s']:.4f} s wall; host alone: "
              f"loader (PIL decode + letterbox, 8 threads) {load_s:.4f} s, evaluator (all {VAL_IMAGES} images) "
              f"{main['eval_s']:.4f} s with the crowd regions, {eval_plain_s:.4f} s on the labels alone; device busy {busy_s:.4f} s in a profiled run of {prof_st['wall_s']:.4f} s "
              f"wall (idle share {1 - busy_s / prof_st['wall_s']:.4f}); {card}", flush=True)
        fps = measure_fps(predb, batch_size=1)
        print(f"validation measure_fps (bf16 top-k folded, batch 1, 30 iterations): {fps:.2f} img/s; {card}",
              flush=True)

        # Drawing: validate_coco(viz_dir=) writes one image an image scored,
        # named by the mode, in the consumer behind the card; the stats are
        # those of the run without it.
        for mode, preprocess in (("file", "host"), ("id", "device")):
            vdir = os.path.join(tmp, f"viz_{mode}")
            st = validate_coco(loaded, images_dir=images_dir, ann_json=ann, imgsz=IMGSZ, batch_size=VAL_BATCH,
                               workers=8, predictor=predb, preprocess=preprocess, viz_dir=vdir, viz_name_mode=mode)
            names = sorted(os.listdir(vdir))
            want = sorted(e["file_name"] if mode == "file" else f"{e['id']}.jpg" for e in entries)
            from PIL import Image

            sizes = {Image.open(os.path.join(vdir, n)).size for n in names}
            ref = stats[f"bf16 top-k {preprocess}"]
            print(f"validation bf16 top-k {preprocess} with viz_dir (names by {mode}): {len(names)} images drawn, "
                  f"sizes {sorted(sizes)}; {st['wall_s']:.4f} s wall against {ref['wall_s']:.4f} s without; "
                  f"stats unchanged {all(st[k] == ref[k] for k in again)}; {card}", flush=True)
            if names != want or any(st[k] != ref[k] for k in again):
                fail(f"validation viz ({mode}, {preprocess}): files {names[:4]}..., expected {want[:4]}...")
            if (preprocess == "host") != (sizes == {(IMGSZ, IMGSZ)}):
                fail(f"validation viz ({mode}, {preprocess}): drawn image sizes {sorted(sizes)}")

        # The CLI, as a user runs it.
        log = os.path.join(tmp, "val_log.csv")
        cli_viz = os.path.join(tmp, "cli_viz")
        cmd = [sys.executable, "-m", "leanyolo_tpu_torch.tools.val", "--model", "yolov10s", "--weights", npz,
               "--images-dir", images_dir, "--ann-json", ann, "--max-images", "16", "--log-csv", log,
               "--viz-dir", cli_viz, "--viz-name-mode", "index"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("mAP50-95=")]
        if r.returncode != 0 or len(line) != 1:
            fail(f"validation CLI: rc {r.returncode}\nstdout {r.stdout[-2000:]}\nstderr {r.stderr[-4000:]}")
        with open(log, newline="") as f:
            rows = list(csv.reader(f))
        if len(rows) != 2 or any(len(row) != 27 for row in rows):
            fail(f"validation CLI: the log has {len(rows)} lines of {[len(row) for row in rows]} columns")
        row = dict(zip(rows[0], rows[1]))
        if (row["runtime"], row["device"], row["n_images"], row["viz_dir"]) != ("torch", "cuda", "16", cli_viz):
            fail(f"validation CLI: row {row}")
        if sorted(os.listdir(cli_viz)) != [f"{i:06d}.jpg" for i in range(16)]:
            fail(f"validation CLI: --viz-dir holds {sorted(os.listdir(cli_viz))[:4]}...")
        print(f"validation CLI (python -m leanyolo_tpu_torch.tools.val, fp32 unfolded, 16 images, 16 drawn by "
              f"index) in {cli_s:.1f} s: "
              f"{line[0]}; CSV row of 27 columns, runtime {row['runtime']}, device {row['device']} "
              f"({row['device_name']})", flush=True)


def phase_variants(seed: int, records: dict) -> None:
    """Every YOLOv10 size at full width and depth (BN calibrated as
    make_model does), folded in bf16 and in fp32, serves a batch through
    Predictor.run_batch on the card with its stem on the kernel route of its
    dtype; the kernel path holds against the all-plain path (check_paths);
    the bf16 stem is timed at [32,640,640,3] against cuDNN and its bound."""
    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, kernels

    by_width = []
    for i, name in enumerate(VARIANTS):
        model = make_model(seed + 10 + i, name)
        rng = np.random.RandomState(seed + 10 + i)
        x = torch.from_numpy(rng.randint(0, 256, (VARIANT_BATCH, IMGSZ, IMGSZ, 3)).astype(np.uint8)).cuda()
        preds = {}
        for dtype in ("bfloat16", "float32"):
            pred = Predictor(model, imgsz=IMGSZ, decode="topk", dtype=dtype, fuse=True, max_det=MAX_DET)
            kernels.reset_launches()
            dets, num = pred.run_batch(x)
            torch.cuda.synchronize()
            got = {k: v for k, v in kernels.LAUNCHES.items() if v}
            print(f"variant {name} {dtype} batch {VARIANT_BATCH}: launches {got}, top score "
                  f"{float(dets[0, 0, 4]):.4f}", flush=True)
            if (got.get("stem") != 1 or got.get("stem_tc", 0) != (dtype == "bfloat16") or got.get("topk") != 2
                    or got.get("argmax") != 1 or got.get("dfl_boxes")):
                fail(f"{name} {dtype}: the stem and the decode's kernels did not launch on their routes: {got}")
            check_dets(dets, num, VARIANT_BATCH)
            preds[dtype] = pred
        cpu32 = Predictor(model, imgsz=IMGSZ, dtype="float32", fuse=True, device="cpu")
        check_paths(preds["bfloat16"], preds["float32"], x, name, cpu32)
        del cpu32
        bb = preds["bfloat16"].model.backbone
        # The device profile only where it is held (yolov10s, against
        # profile_step's): a profile late in a run can take several padded
        # tries (`profiled`), seconds each.
        t = time_stem(bb, torch.Generator(device="cuda").manual_seed(seed + 20 + i), device=name == "yolov10s")
        t = {"variant": name, "c0": bb.cv0.conv.weight.shape[0], "c1": bb.cv1.conv.weight.shape[0], **t}
        # The stem kernels its device-time profile recorded, of KERNEL_INNER launched.
        seen = sum(n for k, n in LAST_PROFILE.items() if "stem_tc_kernel" in k)
        dev = (f" (device {t['device_ms']:.4f}, from {seen} kernel records of {KERNEL_INNER} launches)"
               if "device_ms" in t else "")
        print(f"stem {name} (c0, c1) = ({t['c0']}, {t['c1']}) [{BATCH},{IMGSZ},{IMGSZ},3] uint8 -> bf16: kernel "
              f"{t['ms']:.4f} ms{dev}, cuDNN conv+bias+SiLU x2 {t['library_ms']:.4f}, "
              f"bound {t['bound_ms']:.6f} ({t['bound_by']}), SiLU floor {t.pop('silu_floor_ms'):.6f}", flush=True)
        by_width.append(t)
        lo, hi = STEM_PROFILE_STEP_MS
        if name == "yolov10s" and not 0.9 * lo <= t["device_ms"] <= 1.1 * hi:
            fail(f"stem yolov10s device {t['device_ms']!r} ms, beyond 10% of profile_step's {lo}-{hi} ms")
        del preds, pred, model, bb
        torch.cuda.empty_cache()
    records["stem"]["by_width"] = by_width


# The task-aligned assignment (K6, K7): tests/tal_cases.py's cases and the
# training step's shape ([32, 16, 8400], 80 classes), k = 10 and 1.
TAL_KS = (10, 1)


def tal_check(args, topk: int, label: str) -> None:
    """K6 + K7 on `args` against the plain version on the card, bit for bit:
    the five outputs, and the CIoU and alignment of the check mode; one
    launch of each kernel a call."""
    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.kernels import tal

    nc = args[0].shape[-1]
    before = dict(kernels.LAUNCHES)
    out, mid = tal.assign(*args, topk=topk, num_classes=nc, check=True)
    fast = tal.assign(*args, topk=topk, num_classes=nc)
    ref, ref_mid = tal.assign_plain(*args, topk=topk, num_classes=nc, check=True)
    torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in TAL_PER_STEP}
    same = [same_bits(g, r) for g, r in zip(out, ref)] + [same_bits(g, r) for g, r in zip(fast, ref)]
    same_mid = [same_bits(g, r) for g, r in zip(mid, ref_mid)]
    if launched != {"tal_candidates": 2, "tal_targets": 2} or not all(same + same_mid):
        fg_gap = int((out[3] != ref[3]).sum()) if out[3].shape == ref[3].shape else -1
        fail(f"tal at {label}, k = {topk}: launches {launched}; bits equal (labels, boxes, scores, fg, slot; "
             f"twice) {same}, (overlaps, align) {same_mid}; anchors whose foreground differs {fg_gap}")


def phase_tal_kernels(seed: int, records: dict) -> None:
    """The assignment's kernels against the plain version at every case of
    tests/tal_cases.py and at the training step's shape, k = 10 and 1, and a
    batch against its halves (images are independent)."""
    import torch
    from leanyolo_tpu_torch.kernels import tal

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from tal_cases import CARD_CASES, tal_case, tensors

    for name in CARD_CASES:
        c = tal_case(name, seed)
        args = tensors(c, "cuda")
        for topk in TAL_KS:
            tal_check(args, topk, name)
        print(f"kernel tal_candidates and tal_targets, case {name} {list(args[0].shape)} x {c['gt_labels'].shape[1]} "
              f"slots ({int(c['mask_gt'].sum())} valid), k = {TAL_KS}: the five outputs, CIoU and align bit-equal to "
              f"the plain version", flush=True)
    c = tal_case("step", seed)
    b = c["gt_labels"].shape[0]
    whole = tal.assign(*tensors(c, "cuda"), topk=10, num_classes=c["pd_scores"].shape[-1])
    halves = [tal.assign(*tensors(c, "cuda", r), topk=10, num_classes=c["pd_scores"].shape[-1])
              for r in (slice(0, b // 2), slice(b // 2, b))]
    if not all(same_bits(w, torch.cat([h0, h1])) for w, h0, h1 in zip(whole, *halves)):
        fail("tal: a batch's assignment on the card differs from its halves'")
    print(f"tal at the step's shape: the batch of {b} equals its two halves' assignments bit for bit", flush=True)
    for name in TAL_PER_STEP:
        records[name]["max_abs_err"] = 0.0


TRAIN_GT = 24  # GT slots per image, 40% valid: bench_train.py's draw


def train_batch(rng, b: int, imgsz: int, device):
    """A training batch drawn as bench_train.py draws it: uint8 images,
    labels, xyxy boxes 8-60 px wide, 40% of the slots valid. Images, labels
    and boxes go to `device`; the mask stays on the host, where the trainer
    picks its GT bucket."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    x1, y1 = rng.uniform(0, imgsz - 60, (2, b, TRAIN_GT)).astype(np.float32)
    wh = rng.uniform(8, 60, (2, b, TRAIN_GT)).astype(np.float32)
    images = rng.randint(0, 256, (b, imgsz, imgsz, 3)).astype(np.uint8)
    labels = rng.randint(0, NC, (b, TRAIN_GT)).astype(np.int32)
    boxes = np.stack([x1, y1, x1 + wh[0], y1 + wh[1]], axis=-1)
    mask = rng.uniform(size=(b, TRAIN_GT)) < 0.4
    t = lambda a: torch.from_numpy(a).to(device)
    return SimpleNamespace(images=t(images), gt_labels=t(labels), gt_boxes=t(boxes), gt_mask=mask)


# K8's launches a yolov10s training step: a forward and a backward launch for
# each of its 99 training-mode BNs. With remat="full" every BN sits in a
# checkpointed node or head branch (model.py: each backbone and neck node
# and each head branch is a segment), so the backward's recompute runs each
# forward again: 198 forward launches, 99 backward (the recompute's graph is
# the one differentiated).
BN_PER_STEP = {"bn_moments": 99, "bn_moments_bwd": 99}
BN_PER_STEP_REMAT = {"bn_moments": 198, "bn_moments_bwd": 99}
# The assignment's launches a training step: each kernel once for each
# branch's assignment (one2many at k = 10, one2one at k = 1). The loss lies
# outside remat's checkpoints, so remat="full" recomputes none.
TAL_PER_STEP = {"tal_candidates": 2, "tal_targets": 2}


def check_tal_launches(launches: dict, steps: int, what: str) -> None:
    """Hold the assignment's launches over `steps` steps to TAL_PER_STEP a step."""
    want = {name: k * steps for name, k in TAL_PER_STEP.items()}
    got = {name: launches[name] for name in want}
    if got != want:
        fail(f"tal over {steps} {what}: launches {got}, expected {want}")


def check_bn_launches(launches: dict, steps: int, what: str, per_step: dict) -> None:
    """Hold K8's launches over `steps` steps to `per_step` a step, every one on
    the 16-byte route (every BN input of the path is channels_last, C a
    multiple of 8), and print them."""
    want = {name: k * steps for name, k in per_step.items()}
    want.update({f"{name}_vec": k for name, k in want.items()})
    got = {name: launches[name] for name in want}
    print(f"K8 launches over {steps} {what}: {got}", flush=True)
    if got != want:
        fail(f"K8 over {steps} {what}: launches {got}, expected {want}")


def phase_train(seed: int, records: dict) -> None:
    """The training path at full size, then its checks (see the module doc)."""
    import copy

    import numpy as np
    import torch
    from leanyolo_tpu_torch import TrainConfig, Trainer, YOLOv10, kernels

    names = [f"c{i}" for i in range(NC)]
    rng = np.random.RandomState(seed)
    cfg = TrainConfig(bf16=True, augment=True, grad_clip=1.0, steps_per_epoch=1000)  # bench_train.py:35
    tr = Trainer(YOLOv10.create("yolov10s", class_names=names, seed=seed), cfg)
    batch = train_batch(rng, BATCH, IMGSZ, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, times = [], []
    for i in range(13):  # 3 warm-up steps, then 10 timed
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(tr.train_step(batch, gen))
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"training path launches over 13 steps: {launches}", flush=True)
    records["mpbwd"]["launches"] = launches["mpbwd"]
    if launches["mpbwd"] != 3 * 13:
        fail(f"mpbwd launched {launches['mpbwd']} times over 13 train steps, expected 3 per step")
    check_bn_launches(launches, 13, "train steps", BN_PER_STEP)
    check_tal_launches(launches, 13, "train steps")
    for name in ("bn_moments", "bn_moments_bwd", *TAL_PER_STEP):
        records[name]["launches"] = launches[name]
    totals = [float(l["total"]) for l in losses]
    if not all(np.isfinite([float(v) for l in losses for v in l.values()])):
        fail(f"non-finite training losses: {totals}")
    step_ms = [s.elapsed_time(e) for s, e in times[3:]]
    ms = statistics.median(step_ms)
    print(f"train yolov10s 640 bf16 batch {BATCH}: ms/step median {ms:.4f} mean {statistics.mean(step_ms):.4f} "
          f"(min {min(step_ms):.4f} max {max(step_ms):.4f}), img/s {BATCH / ms * 1e3:.2f}; peak memory {peak:.2f} GiB; "
          f"{card_line()}", flush=True)
    print(f"train losses (total) over the 13 steps: {[round(v, 4) for v in totals]}", flush=True)

    # Where a train step's device time goes (2 steps).
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            tr.train_step(batch, gen)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 2 * 1e3
    # Device events, without the ranges the profiler annotates on the device
    # timeline around whole calls (e.g. "Optimizer.step#AdamW.step"), whose
    # time overlaps the kernels inside them.
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in events) / 2 / 1e3
    calls = sum(e.count for e in events) // 2
    print(f"train profile, 2 steps: device time {total:.4f} ms/step ({calls} device calls/step), "
          f"{wall:.4f} ms wall under the profiler; against the unprofiled median step the card is busy "
          f"{total / ms:.3f} of the step; top kernels:", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 2 / 1e3:9.4f} ms/step {e.count // 2:5d} calls/step  {e.key[:90]}",
              flush=True)
    with check_time(TAL_CHECK_S, "K6 and K7 on a training step's own inputs"):
        tal_calls = capture_tal_calls(tr, batch, gen)
    del tr, batch, losses
    torch.cuda.empty_cache()

    # The loss on one fixed batch falls (no augmentation).
    tr = Trainer(YOLOv10.create("yolov10s", class_names=names, seed=seed + 1),
                 TrainConfig(bf16=True, augment=False, grad_clip=1.0, steps_per_epoch=1000))
    batch = train_batch(rng, BATCH, IMGSZ, "cuda")
    fixed = [float(tr.train_step(batch)["total"]) for _ in range(20)]
    print(f"fixed batch, 20 steps, total loss: {[round(v, 4) for v in fixed]}", flush=True)
    if not (np.isfinite(fixed).all() and max(fixed[-5:]) < fixed[0]):
        fail("the loss on a fixed batch did not fall over 20 steps")
    del tr, batch
    torch.cuda.empty_cache()

    # fp32, one step from the same state: the kernel path against the plain
    # path, cuDNN deterministic. mpbwd is bit-equal to its plain version, so
    # the grads and the BN statistics agree to 1e-5 of their scale.
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    f32cfg = TrainConfig(bf16=False, augment=False, grad_clip=1.0)
    model = YOLOv10.create("yolov10s", class_names=names, seed=seed + 2)
    batch = train_batch(rng, 8, IMGSZ, "cuda")
    tk, tp = Trainer(copy.deepcopy(model), f32cfg), Trainer(model, f32cfg)
    before = dict(kernels.LAUNCHES)
    lk = tk.forward_backward(batch)
    if kernels.LAUNCHES["mpbwd"] != before["mpbwd"] + 3:
        fail("the fp32 kernel step did not launch mpbwd three times")
    check_bn_launches({k: v - before[k] for k, v in kernels.LAUNCHES.items()}, 1, "fp32 kernel steps", BN_PER_STEP)
    check_tal_launches({k: v - before[k] for k, v in kernels.LAUNCHES.items()}, 1, "fp32 kernel steps")
    with plain_kernels():
        lp = tp.forward_backward(batch)
    torch.cuda.synchronize()
    cudnn.deterministic, cudnn.benchmark = saved
    worst_g = worst_s = 0.0
    for (name, a), (_, b) in zip(tk.model.named_parameters(), tp.model.named_parameters()):
        worst_g = max(worst_g, max_err(a.grad, b.grad) / max(1e-12, float(b.grad.abs().max())))
    for (name, a), (_, b) in zip(tk.model.named_buffers(), tp.model.named_buffers()):
        worst_s = max(worst_s, max_err(a, b) / max(1.0, float(b.abs().max())))
    print(f"fp32 train step yolov10s 640 batch 8, kernel vs plain path: loss {float(lk['total']):.6f} vs "
          f"{float(lp['total']):.6f}; worst grad gap {worst_g:.3g} of the tensor's scale, worst BN statistic gap "
          f"{worst_s:.3g}", flush=True)
    if not (worst_g <= 1e-5 and worst_s <= 1e-5):
        fail("fp32 train step: the kernel path disagrees with the plain path")
    del tk, tp, model, batch
    torch.cuda.empty_cache()

    # fp32, one step on the card against the CPU: yolov10n, 128 px, batch 2.
    model = YOLOv10.create("yolov10n", class_names=names, seed=seed + 3)
    small = train_batch(rng, 2, 128, "cpu")
    small.gt_mask[:, 0] = True
    on_card = Trainer(copy.deepcopy(model), f32cfg).forward_backward(small)["total"]
    on_cpu = Trainer(model, f32cfg, device="cpu").forward_backward(small)["total"]
    gap = abs(float(on_card) - float(on_cpu)) / abs(float(on_cpu))
    print(f"fp32 train step yolov10n 128 batch 2: loss card {float(on_card):.6f} CPU {float(on_cpu):.6f}, "
          f"relative gap {gap:.3g}", flush=True)
    if not gap <= 1e-4:
        fail("fp32 train step: the card disagrees with the CPU")
    return tal_calls


def capture_tal_calls(tr, batch, gen) -> list:
    """The assignment's inputs in one training step of `tr` (one2many at k =
    10, one2one at k = 1), copied, each held: the kernels against the plain
    version, bit for bit (check mode)."""
    from leanyolo_tpu_torch.tools.time_train_kernels import capture_tal_calls as capture

    calls = capture(tr, batch, gen)
    if [kw["topk"] for _, kw in calls] != [10, 1]:
        fail(f"a training step called the assignment with topk {[kw['topk'] for _, kw in calls]}, expected [10, 1]")
    for args, kw in calls:
        tal_check(args, kw["topk"], f"a training step's inputs {list(args[0].shape)} x {args[3].shape[1]} slots "
                                    f"({int(args[5].sum())} valid), strides {args[0].stride()}")
    print(f"tal on a batch-{BATCH} training step's own inputs (k = 10 and 1): bit-equal to the plain version, "
          f"the CIoU and align too", flush=True)
    return calls


def phase_train_times(seed: int, records: dict, tal_calls: list) -> None:
    """mpbwd at the training path's SPPF shape: the kernel, its plain
    version, and aten's max-pool backward with indices from the forward;
    then K8 (`time_bn_moments`) and K6 + K7 (`time_tal`)."""
    import torch
    import torch.nn.functional as F
    from leanyolo_tpu_torch.kernels import bounds, mpbwd

    g = torch.Generator(device="cuda").manual_seed(seed + 4)
    x = torch.randn(BATCH, 20, 20, 256, generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn(BATCH, 20, 20, 256, generator=g, device="cuda").to(torch.bfloat16)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels_last NCHW views, as in the model
    _, idx = F.max_pool2d(xc, 5, 1, 2, return_indices=True)
    r = records["mpbwd"]
    r["ms"] = events_ms(lambda: mpbwd.mpbwd(x, dy), inner=KERNEL_INNER)
    r["device_ms"] = device_ms(lambda: mpbwd.mpbwd(x, dy))
    r["plain_ms"] = events_ms(lambda: mpbwd.mpbwd_plain(x, dy), inner=KERNEL_INNER)
    r["library_ms"] = events_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        dyc, xc, [5, 5], [1, 1], [2, 2], [1, 1], False, idx), inner=KERNEL_INNER)
    set_bound(r, *bounds.mpbwd_work(*x.shape, k=5, elt=x.element_size()), "fp32")
    print(f"mpbwd [{BATCH},20,20,256] bf16 ({mpbwd.route(x, dy, x)} route): kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f}), plain {r['plain_ms']:.4f}, aten max_pool2d_with_indices_backward "
          f"{r['library_ms']:.4f}, bound {r['bound_ms']:.6f} ({r['bound_by']})", flush=True)
    # The general route at the same work, on a map whose C holds no whole
    # 16-byte vector (printed, no record).
    xg = torch.randn(BATCH, 20, 20, 255, generator=g, device="cuda").to(torch.bfloat16)
    dyg = torch.randn(BATCH, 20, 20, 255, generator=g, device="cuda").to(torch.bfloat16)
    t_g = events_ms(lambda: mpbwd.mpbwd(xg, dyg), inner=KERNEL_INNER)
    print(f"mpbwd [{BATCH},20,20,255] bf16 ({mpbwd.route(xg, dyg, xg)} route): kernel {t_g:.4f} ms", flush=True)
    del x, dy, xg, dyg, xc, dyc, idx
    with check_time(BN_CHECK_S, "K8 timed"):
        time_bn_moments(seed, records)
    with check_time(TAL_CHECK_S, "K6 and K7 timed"):
        time_tal(records, tal_calls)


def time_tal(records: dict, calls: list) -> None:
    """The assignment's two kernels on a training step's own inputs (`calls`:
    one2many at k = 10 and one2one at k = 1), each kernel alone, summed over
    the step's two calls (tools/time_train_kernels.py::time_tal_calls):
    CUDA events (the mean of 10 back-to-back launches), the profiler's
    device time, the plain version's matching pass and the bound. No single
    PyTorch call computes the assignment: library none."""
    from leanyolo_tpu_torch.tools.time_train_kernels import time_tal_calls

    timed = time_tal_calls(calls, full=True)
    for name in TAL_PER_STEP:
        records[name].update(timed[name], library_ms=None)
    f, t = records["tal_candidates"], records["tal_targets"]
    print(f"tal, a batch-{BATCH} yolov10s {IMGSZ} training step's two calls summed: tal_candidates {f['ms']:.5f} ms "
          f"(device {f['device_ms']:.5f}), plain {f['plain_ms']:.4f}, bound {f['bound_ms']:.6f} ({f['bound_by']}); "
          f"tal_targets {t['ms']:.5f} ms (device {t['device_ms']:.5f}), plain {t['plain_ms']:.4f}, bound "
          f"{t['bound_ms']:.6f} ({t['bound_by']}); library: none; {card_line()}", flush=True)


def time_bn_moments(seed: int, records: dict) -> None:
    """K8 forward and backward summed over the 99 BN inputs of a batch-32
    yolov10s 640 bf16 training forward (tools/time_train_kernels.py::time_bn:
    each of the 14 shapes timed once and counted as often as the step has
    it), beside the plain version and the library's one call for the same
    function (torch.batch_norm_stats, torch.addcmul; timed only); the device
    time from profiles of the step's 99 launches in order."""
    from leanyolo_tpu_torch.tools.time_train_kernels import time_bn

    timed = time_bn(seed, full=True)
    f, b = records["bn_moments"], records["bn_moments_bwd"]
    f.update(timed["bn_moments"])
    b.update(timed["bn_moments_bwd"])
    print(f"bn_moments, the {len(train_bn_shapes())} BNs of a batch-{BATCH} yolov10s {IMGSZ} bf16 training forward, "
          f"summed: kernel {f['ms']:.4f} ms (device {f['device_ms']:.4f}, the 99 in a row, {f['device_records']}), "
          f"plain {f['plain_ms']:.4f}, torch.batch_norm_stats {f['library_ms']:.4f}, bound {f['bound_ms']:.4f} "
          f"(bytes); bn_moments_bwd: kernel {b['ms']:.4f} ms (device {b['device_ms']:.4f}, {b['device_records']}), "
          f"plain {b['plain_ms']:.4f}, torch.addcmul {b['library_ms']:.4f}, bound {b['bound_ms']:.4f} (bytes); "
          f"{card_line()}", flush=True)


WIDE_IMGSZ = 1536  # 192^2 + 96^2 + 48^2 = 48,384 anchors: the candidates kernel in two passes


def phase_wide_train(seed: int) -> None:
    """One yolov10n training step at 1536 px, batch 2 (bench_train.py's
    draw): A = 48,384 anchors, past the candidates kernel's one pass; the
    step's two assignments held to the plain version bit for bit (check
    mode), and the step's launches."""
    import numpy as np
    import torch
    from leanyolo_tpu_torch import TrainConfig, Trainer, YOLOv10, kernels
    from leanyolo_tpu_torch.kernels import tal
    from leanyolo_tpu_torch.tools.bench_train import synthetic_batch
    from leanyolo_tpu_torch.tools.time_train_kernels import capture_tal_calls as capture
    from types import SimpleNamespace

    images, labels, boxes, mask = synthetic_batch(2, WIDE_IMGSZ, TRAIN_GT, seed)
    mask[:, :2] = True
    up = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    batch = SimpleNamespace(images=up(images), gt_labels=up(labels), gt_boxes=up(boxes), gt_mask=mask)
    tr = Trainer(YOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(NC)], seed=seed),
                 TrainConfig(bf16=True, augment=True, grad_clip=1.0, steps_per_epoch=1000))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = dict(kernels.LAUNCHES)
    losses = tr.train_step(batch, gen)
    torch.cuda.synchronize()
    launched = {name: kernels.LAUNCHES[name] - before[name] for name in TAL_PER_STEP}
    total = float(losses["total"])
    if launched != TAL_PER_STEP or not np.isfinite(total):
        fail(f"yolov10n {WIDE_IMGSZ} px training step: tal launches {launched}, loss {total}")
    calls = capture(tr, batch, gen)
    for args, kw in calls:
        if args[0].shape[1] <= tal.PASS_A:
            fail(f"the {WIDE_IMGSZ} px step's assignment has {args[0].shape[1]} anchors, not past {tal.PASS_A}")
        tal_check(args, kw["topk"], f"a {WIDE_IMGSZ} px training step's inputs {list(args[0].shape)}")
    print(f"train yolov10n {WIDE_IMGSZ} px bf16 batch 2: loss {total:.4f}, tal launches {launched}; its "
          f"assignments (A = {calls[0][0][0].shape[1]}, k = 10 and 1) bit-equal to the plain version", flush=True)


BENCH_CHAIN = 8  # back-to-back requests a timed chain of the bench phase
BENCH_GAP = 0.15  # the chained figure and the idle-card request's, apart by more: explained in PERF.md


def bench_json(out: str, metric: str, card: str) -> dict:
    """The bench CLI's JSON line, held to its metric name and the card."""
    import torch

    line = json.loads(out.strip().splitlines()[-1])
    d = line["detail"]
    if line["metric"] != metric or not line["value"] > 0 or (d["device"], d["card"]) != (
            torch.cuda.get_device_name(0), card):
        fail(f"bench: {line}, expected {metric} on {card}")
    return line


def bench_main(main, argv) -> str:
    """A bench CLI's main(argv) in this process (grad on, as a CLI runs):
    its standard output."""
    import io

    import torch

    out = io.StringIO()
    with contextlib.redirect_stdout(out), torch.enable_grad():
        main(argv)
    return out.getvalue()


def phase_bench(card: str, run_batch_ms: float, tmp: str) -> None:
    """The bench CLIs: bench (yolov10s 640 top-k, batch 32, a chain of
    BENCH_CHAIN) as a user runs it, a process of its own alone on the card,
    beside 32 / the serving path's batch-32 request time from an idle card
    (phase 5's CUDA events); in this process, through their main(argv),
    bench --latency for both decodes, bench_train (yolov10n 640, batch 8, 4
    steps) and bench_matrix over yolov10n's infer, nms and train cells at
    batch 8 with --out; then, two processes at once, bench_regression of
    that file against itself (exit 0) and against a copy with one cell
    doubled (exit 1)."""
    from leanyolo_tpu_torch.tools import bench, bench_matrix, bench_train

    out, _, wall = run_tool("bench", ["--batch-sizes", BATCH, "--chain", BENCH_CHAIN])
    ips = bench_json(out, "yolov10s_640_bf16_images_per_sec_per_chip", card)["value"]
    idle = BATCH / run_batch_ms * 1e3
    print(f"bench yolov10s 640 bf16 top-k batch {BATCH}, a chain of {BENCH_CHAIN}: {ips} img/s ({wall:.1f} s); "
          f"{BATCH} / the idle-card request's {run_batch_ms:.4f} ms: {idle:.2f} img/s; chained / idle "
          f"{ips / idle:.3f}{' (apart by more than 15%)' if abs(ips / idle - 1) > BENCH_GAP else ''}; {card}",
          flush=True)
    t0 = time.perf_counter()
    for decode, tag in (("topk", ""), ("nms", "_nms")):
        out = bench_main(bench.main, ["--latency", "--decode", decode, "--chains", "8,32"])
        line = bench_json(out, f"yolov10s_640_bf16{tag}_bs1_latency_ms", card)
        print(f"bench --latency --decode {decode}: {line['value']} ms a request, "
              f"{line['detail']['wall_ms_per_step_by_chain']} ms a request by chain", flush=True)
    out = bench_main(bench_train.main, ["--variant", "yolov10n", "--batch-sizes", "8", "--steps", "4"])
    line = bench_json(out, "yolov10n_640_bf16_train_images_per_sec_per_chip", card)
    print(f"bench_train yolov10n 640 bf16 batch 8, 4 steps: {line['value']} img/s", flush=True)
    path = os.path.join(tmp, "bench_matrix.json")
    out = bench_main(bench_matrix.main, ["--variants", "yolov10n", "--modes", "infer,nms,train", "--batch-sizes", "8",
                                         "--chain", "4", "--steps", "2", "--out", path])
    with open(path) as f:
        table = json.load(f)
    cells = table["cells"]
    if sorted(cells) != ["yolov10n/infer", "yolov10n/nms", "yolov10n/train"] or table["card"] != card or not all(
            c["batch_size"] == 8 and c["images_per_sec_per_chip"] > 0 for c in cells.values()):
        fail(f"bench_matrix: {table}")
    print(f"bench_matrix yolov10n at batch 8: {out.strip().splitlines()[-5:-2]}; the three CLIs in this process "
          f"took {time.perf_counter() - t0:.1f} s", flush=True)
    doubled = json.loads(json.dumps(table))
    doubled["cells"]["yolov10n/nms"]["images_per_sec_per_chip"] *= 2
    with open(os.path.join(tmp, "doubled.json"), "w") as f:
        json.dump(doubled, f)
    same, gate = run_at_once([tool_argv("bench_regression", ["--baseline", base, "--current", path])
                              for base in (path, os.path.join(tmp, "doubled.json"))])
    if same[2] != 0 or gate[2] != 1 or "yolov10n/nms" not in gate[0].split("FAILED")[-1]:
        fail(f"bench_regression: against itself rc {same[2]}: {same[0]}; against a doubled cell rc {gate[2]}: "
             f"{gate[0]}")
    print("bench_regression: the matrix against itself exits 0, against a copy with yolov10n/nms doubled exits 1",
          flush=True)


# Phase 11: training from a folder, as a user trains.
FOLDER_TRAIN, FOLDER_VAL = 64, 32  # images of the train and val sets
SHAPES = ("rect", "circle", "triangle")  # class i is shape i in colour i
SHAPE_RGB = ((200, 40, 40), (40, 200, 40), (40, 40, 200))
FOLDER_STEPS = 2  # timed steps a preprocess mode, after an epoch's warm-up
CLI_EPOCHS = 3
# The CLIs in a subprocess, with cuDNN and PyTorch on deterministic
# algorithms, so a resumed run can be held to the uninterrupted one bit for bit.
DETERMINISTIC_CLI = ("import sys, torch; torch.backends.cudnn.deterministic = True; "
                     "torch.backends.cudnn.benchmark = False; torch.use_deterministic_algorithms(True, warn_only=True); "
                     "torch.utils.deterministic.fill_uninitialized_memory = False; "
                     "from leanyolo_tpu_torch.tools.{module} import main; main(sys.argv[1:])")


def write_shape_set(root: str, n: int, seed: int):
    """n JPEGs (PIL) at the VAL_SIZES in turn: 1-3 filled shapes of fixed
    class and colour (tests/synth_coco.py::make_learnable_coco's set:
    rectangle, circle, triangle) on grey noise, and their COCO json.
    Returns (images dir, annotations path)."""
    import numpy as np
    from PIL import Image, ImageDraw

    rng = np.random.RandomState(seed)
    images_dir = os.path.join(root, "images")
    os.makedirs(images_dir)
    images, anns = [], []
    for i in range(n):
        w, h = VAL_SIZES[i % len(VAL_SIZES)]
        im = Image.fromarray(rng.randint(90, 130, (h, w, 3)).astype(np.uint8))
        draw = ImageDraw.Draw(im)
        for _ in range(rng.randint(1, 4)):
            cls = int(rng.randint(0, 3))
            s = int(rng.uniform(0.18, 0.4) * min(h, w))
            x, y = int(rng.uniform(0, w - s - 1)), int(rng.uniform(0, h - s - 1))
            color = tuple(int(v) for v in np.clip(np.asarray(SHAPE_RGB[cls]) + rng.randint(-25, 26, 3), 0, 255))
            if cls == 0:
                draw.rectangle((x, y, x + s, y + s), fill=color)
            elif cls == 1:
                draw.ellipse((x, y, x + s, y + s), fill=color)
            else:
                draw.polygon([(x + s // 2, y), (x, y + s), (x + s, y + s)], fill=color)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": cls + 1,
                         "bbox": [float(x), float(y), float(s + 1), float(s + 1)], "area": float((s + 1) ** 2),
                         "iscrowd": 0})
        name = f"{i:06d}.jpg"
        im.save(os.path.join(images_dir, name), quality=90)
        images.append({"id": i + 1, "file_name": name, "width": w, "height": h})
    ann = os.path.join(root, "annotations.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": k + 1, "name": s} for k, s in enumerate(SHAPES)]}, f)
    return images_dir, ann


def run_clis(*clis) -> list:
    """`python -c` running each CLI's main on its args (DETERMINISTIC_CLI),
    all at once, each (module, args): [(stdout + stderr, wall seconds)];
    fails on a non-zero exit."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    jobs = [Job([sys.executable, "-c", DETERMINISTIC_CLI.format(module=module), *args], env=env)
            for module, args in clis]
    outs = []
    for (module, args), (out, err, rc, wall) in zip(clis, wait_all(jobs)):
        if rc != 0:
            fail(f"{module} CLI {args}: rc {rc}\nstdout {out[-3000:]}\nstderr {err[-4000:]}")
        outs.append((out + err, wall))
    return outs


def timed_steps(tr, batches, gen, n: int):
    """Run the trainer on `batches` in turn for n steps, each timed with CUDA
    events: (per-step ms, losses)."""
    import torch

    times, losses = [], []
    for i in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(tr.train_step(batches[i % len(batches)], gen))
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in times], losses


def phase_train_folder(seed: int, records: dict, card: str, tmp: str) -> tuple:
    """Training from a COCO-format folder in process (item 11 of the module
    doc); writes the sets under `tmp`: (train images, train annotations,
    val images, val annotations)."""
    import copy

    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, TrainConfig, Trainer, YOLOv10, kernels
    from leanyolo_tpu_torch.data.dataset import CocoDetection, DataLoader
    from leanyolo_tpu_torch.engine.validator import validate_coco

    names = list(SHAPES)
    tr_dir, tr_ann = write_shape_set(os.path.join(tmp, "train"), FOLDER_TRAIN, seed + 11)
    va_dir, va_ann = write_shape_set(os.path.join(tmp, "val"), FOLDER_VAL, seed + 12)

    # Loader and trainer in process, host and device letterbox, bf16 at
    # batch 32. Peak memory is the mode's own: above what was allocated
    # before its trainer was made (the other mode's trainer, earlier phases).
    runs = {}
    for mode in ("host", "device"):
        loader = DataLoader(CocoDetection(tr_dir, tr_ann, img_size=IMGSZ, preprocess=mode), batch_size=BATCH,
                            shuffle=True, seed=seed)
        cfg = TrainConfig(bf16=True, augment=True, grad_clip=1.0, steps_per_epoch=len(loader),
                          device_preprocess=mode == "device", imgsz=IMGSZ)
        base = torch.cuda.memory_allocated()
        tr = Trainer(YOLOv10.create("yolov10s", class_names=names, seed=seed), cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        t0 = time.perf_counter()
        warm = list(loader)  # epoch 0: the batches of the warm-up
        load_s = time.perf_counter() - t0
        for b in warm:
            tr.train_step(b, gen)
        batches = list(loader)  # epoch 1's batches, another order
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        step_ms, losses = timed_steps(tr, batches, gen, FOLDER_STEPS)
        launches = dict(kernels.LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        totals = [float(l["total"]) for l in losses]
        if not np.isfinite([float(v) for l in losses for v in l.values()]).all():
            fail(f"train from a folder ({mode} letterbox): non-finite losses {totals}")
        if launches["mpbwd"] != 3 * FOLDER_STEPS:
            fail(f"train from a folder ({mode}): mpbwd launched {launches['mpbwd']} times over "
                 f"{FOLDER_STEPS} steps, expected 3 a step")
        check_bn_launches(launches, FOLDER_STEPS, f"steps from a folder ({mode} letterbox)", BN_PER_STEP)
        check_tal_launches(launches, FOLDER_STEPS, f"steps from a folder ({mode} letterbox)")
        records["mpbwd"][f"launches_folder_{mode}"] = launches["mpbwd"]
        print(f"train from a folder, {mode} letterbox, yolov10s 640 bf16 batch {BATCH} ({FOLDER_TRAIN} images, "
              f"augment, clip 1.0): ms/step median {statistics.median(step_ms):.4f} (CUDA events, "
              f"{[round(v, 4) for v in step_ms]}), peak memory {peak:.4f} GiB, loader {load_s:.4f} s for an "
              f"epoch of {len(warm)} batches; mpbwd launches {launches['mpbwd']} over {FOLDER_STEPS} steps; "
              f"losses {[round(v, 4) for v in totals]}; {card}", flush=True)
        runs[mode] = (tr, batches, gen)
        if mode == "device":
            # The per-epoch validation of the CLIs: fp32, unfolded, top-k.
            pred = Predictor(tr.model, imgsz=IMGSZ, decode="topk", conf_thresh=0.001, iou_thresh=0.65)
            kernels.reset_launches()
            t0 = time.perf_counter()
            st = validate_coco(tr.model, images_dir=va_dir, ann_json=va_ann, imgsz=IMGSZ, batch_size=BATCH,
                               predictor=pred)
            val_s = time.perf_counter() - t0
            n_topk = kernels.LAUNCHES["topk"]
            if n_topk != 2 * (FOLDER_VAL // BATCH) or not np.isfinite(st["map_50_95"]):
                fail(f"the CLIs' validation: top-k launched {n_topk} times, mAP {st['map_50_95']}")
            records["topk"]["launches_folder_val"] = n_topk
            print(f"the CLIs' validation (fp32 unfolded top-k, {FOLDER_VAL} images) after "
                  f"{len(warm) + FOLDER_STEPS} steps: mAP50-95 {st['map_50_95']:.5f}, {val_s:.4f} s wall, top-k "
                  f"launches {n_topk}; {card}", flush=True)
            del pred
    # Step time of the two modes in turns (host, device, device, host),
    # so the drift of a host-bound step falls on both.
    turns = {"host": [], "device": []}
    for order in (("host", "device"), ("device", "host")):
        for mode in order:
            turns[mode] += timed_steps(*runs[mode], FOLDER_STEPS)[0]
    print(f"train from a folder, ms/step in turns (host, device, device, host; {FOLDER_STEPS} steps a turn, CUDA "
          f"events): host median {statistics.median(turns['host']):.4f} "
          f"({[round(v, 4) for v in turns['host']]}), device median {statistics.median(turns['device']):.4f} "
          f"({[round(v, 4) for v in turns['device']]}); {card}", flush=True)
    device_batches = runs["device"][1]
    del runs, tr
    torch.cuda.empty_cache()

    # remat="full" against "none": one fp32 step from one state and batch
    # (device letterbox, batch 8, deterministic cuDNN), then peak memory
    # and step time of both in bf16 at batch 32.
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    small = next(iter(DataLoader(CocoDetection(tr_dir, tr_ann, img_size=IMGSZ, preprocess="device"),
                                 batch_size=8)))
    model = YOLOv10.create("yolov10s", class_names=names, seed=seed + 13)
    f32 = {r: Trainer(copy.deepcopy(model), TrainConfig(augment=False, grad_clip=1.0, remat=r,
                                                        device_preprocess=True, imgsz=IMGSZ))
           for r in ("none", "full")}
    loss = {}
    for r, t in f32.items():
        before = dict(kernels.LAUNCHES)
        loss[r] = float(t.train_step(small)["total"])
        check_bn_launches({k: v - before[k] for k, v in kernels.LAUNCHES.items()}, 1, f"remat={r!r} fp32 steps",
                          BN_PER_STEP_REMAT if r == "full" else BN_PER_STEP)
        check_tal_launches({k: v - before[k] for k, v in kernels.LAUNCHES.items()}, 1, f"remat={r!r} fp32 steps")
    torch.cuda.synchronize()
    cudnn.deterministic, cudnn.benchmark = saved
    mn, mf = f32["none"].model, f32["full"].model
    worst_g = worst_p = 0.0
    for (name, a), (_, b) in zip(mf.named_parameters(), mn.named_parameters()):
        worst_g = max(worst_g, max_err(a.grad, b.grad) / max(1e-12, float(b.grad.abs().max())))
        worst_p = max(worst_p, max_err(a.detach(), b.detach()) / max(1e-12, float(b.detach().abs().max())))
    stats_equal = all(torch.equal(a, b) for (k, a), (_, b) in zip(mf.state_dict().items(), mn.state_dict().items())
                      if "running" in k)
    moved = not torch.equal(mf.backbone.cv0.bn.running_mean, model.backbone.cv0.bn.running_mean.cuda())
    print(f"remat full vs none, fp32 step yolov10s 640 batch 8 (device letterbox): loss {loss['full']:.6f} vs "
          f"{loss['none']:.6f}; worst grad gap {worst_g:.3g}, worst parameter gap {worst_p:.3g} of the tensor's "
          f"scale; BN running statistics equal: {stats_equal}", flush=True)
    if not (worst_g <= 1e-5 and worst_p <= 1e-5 and stats_equal and moved):
        fail("remat='full' disagrees with remat='none' (or the BN statistics did not advance once)")
    del f32, mn, mf, small
    torch.cuda.empty_cache()
    peaks = {}
    for r in ("none", "full"):
        cfg = TrainConfig(bf16=True, augment=True, grad_clip=1.0, remat=r, device_preprocess=True, imgsz=IMGSZ)
        base = torch.cuda.memory_allocated()
        tr = Trainer(YOLOv10.create("yolov10s", class_names=names, seed=seed), cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tr.train_step(device_batches[0], gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, _ = timed_steps(tr, device_batches, gen, FOLDER_STEPS)
        peaks[r] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"remat={r!r}, yolov10s 640 bf16 batch {BATCH} (device letterbox): peak memory {peaks[r]:.4f} GiB, "
              f"ms/step median {statistics.median(step_ms):.4f} ({[round(v, 4) for v in step_ms]}); {card}",
              flush=True)
        del tr
        torch.cuda.empty_cache()
    if not peaks["full"] < peaks["none"]:
        fail(f"remat='full' did not lower peak memory: {peaks}")
    return tr_dir, tr_ann, va_dir, va_ann


def phase_train_clis(seed: int, card: str, tmp: str, sets: tuple) -> None:
    """The train and transfer CLIs on phase_train_folder's sets, two at a
    time (item 11 of the module doc)."""
    import numpy as np

    tr_dir, tr_ann, va_dir, va_ann = sets
    # The train CLI: 3 epochs, device letterbox, bf16, augment; at the same
    # time a run of 2 epochs, then resumed to 3 beside the transfer CLI.
    # Warmup is one epoch and the cosine starts at its top, so a 2-epoch
    # run's schedule is the 3-epoch run's for its two epochs: stopping there
    # is stopping the 3-epoch run. Deterministic algorithms make a run's bits
    # its own, whatever runs beside it.
    common = ["--model", "yolov10s", "--train-images", tr_dir, "--train-ann", tr_ann, "--val-images", va_dir,
              "--val-ann", va_ann, "--imgsz", str(IMGSZ), "--batch-size", str(BATCH), "--bf16", "--augment",
              "--preprocess", "device", "--seed", str(seed), "--log-interval", "1"]
    full, part = os.path.join(tmp, "train_full"), os.path.join(tmp, "train_part")
    (out, wall), (_, wall2) = run_clis(("train", common + ["--epochs", str(CLI_EPOCHS), "--out-dir", full]),
                                       ("train", common + ["--epochs", "2", "--out-dir", part]))
    with open(os.path.join(full, "history.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = {"epoch", "loss_total", "loss_cls", "loss_reg", "steps", "time_s", "img_s", "map_50_95", "map_50"}
    if len(rows) != CLI_EPOCHS or any(set(r) != keys for r in rows) or "eval failed" in out:
        fail(f"train CLI: history {rows}\n{out[-3000:]}")
    if not all(np.isfinite([r[k] for k in ("loss_total", "loss_cls", "loss_reg", "map_50_95")]).all()
               for r in rows):
        fail(f"train CLI: non-finite history {rows}")
    if not rows[-1]["loss_total"] < rows[0]["loss_total"]:
        fail(f"train CLI: the last epoch's mean loss is not below the first's: {rows}")
    files = [f"epoch{e:03d}.npz" for e in range(1, CLI_EPOCHS + 1)] + ["last.npz", "ckpt.npz", "train_state.pt"]
    if any(not os.path.exists(os.path.join(full, f)) for f in files):
        fail(f"train CLI: missing checkpoints in {sorted(os.listdir(full))}")
    print(f"train CLI (python -m leanyolo_tpu_torch.tools.train, yolov10s 640 bf16 batch {BATCH}, device "
          f"letterbox, {CLI_EPOCHS} epochs of {FOLDER_TRAIN} images, validation on {FOLDER_VAL}) in {wall:.1f} s "
          f"wall, beside the 2-epoch run and the shortened QT-001's training; per epoch loss_total "
          f"{[round(r['loss_total'], 4) for r in rows]}, mAP50-95 {[r['map_50_95'] for r in rows]}, mAP50 "
          f"{[r['map_50'] for r in rows]}, epoch s {[r['time_s'] for r in rows]}; {card}", flush=True)

    # The resumed run, and beside it the transfer CLI from the train CLI's
    # 3-class ckpt.npz onto a 2-class set.
    with open(tr_ann) as f:
        gt = json.load(f)
    gt["categories"] = gt["categories"][:2]
    gt["annotations"] = [a for a in gt["annotations"] if a["category_id"] <= 2]
    two = os.path.join(tmp, "two_classes.json")
    with open(two, "w") as f:
        json.dump(gt, f)
    tl = os.path.join(tmp, "transfer")
    (out3, wall3), (out, wall) = run_clis(
        ("train", common + ["--epochs", str(CLI_EPOCHS), "--out-dir", part, "--resume"]),
        ("transfer_learn", [
            "--model", "yolov10s", "--weights", os.path.join(full, "ckpt.npz"), "--train-images", tr_dir,
            "--train-ann", two, "--val-images", tr_dir, "--val-ann", two, "--max-val-images", str(FOLDER_VAL),
            "--imgsz", str(IMGSZ), "--batch-size", str(BATCH), "--epochs", "2", "--unfreeze-epoch", "1",
            "--seed", str(seed), "--viz-interval", "2", "--out-dir", tl]))
    if "resumed from" not in out3:
        fail(f"train CLI --resume did not resume:\n{out3[-3000:]}")
    with np.load(os.path.join(full, "last.npz")) as a, np.load(os.path.join(part, "last.npz")) as b:
        gaps = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a.files if a[k].dtype != np.uint8}
        same = a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    print(f"train CLI stopped after epoch 2 ({wall2:.1f} s) and resumed to {CLI_EPOCHS} ({wall3:.1f} s, beside the "
          f"transfer CLI): last.npz bit-equal to the uninterrupted run's: {same} (largest gap "
          f"{max(gaps.values()):.3g}); {card}", flush=True)
    if not same:
        fail("train CLI: the resumed run's last.npz differs from the uninterrupted run's")
    cover = [ln for ln in out.splitlines() if "transfer init from" in ln]
    skipped = int(cover[0].split("loaded, ")[1].split(" ")[0]) if cover else 0
    vals = [ln.split(" ", 2)[2] for ln in out.splitlines() if " VAL epoch " in ln]
    need = ("head reset to fresh random init", "UNFREEZE backbone at epoch 2", "RUN END best mAP50-95=")
    if (not skipped or len(vals) != 2 or "VAL failed" in out or any(s not in out for s in need)
            or not os.path.exists(os.path.join(tl, "best.npz"))):
        fail(f"transfer CLI:\n{out[-3000:]}")
    snaps = sorted(os.listdir(os.path.join(tl, "viz")))
    if not snaps or snaps[0] != "step000002.jpg" or out.count("[viz] saved:") != len(snaps):
        fail(f"transfer CLI --viz-interval 2: snapshots {snaps}")
    print(f"transfer CLI (python -m leanyolo_tpu_torch.tools.transfer_learn, 3-class ckpt.npz onto 2 classes, "
          f"bf16, host letterbox, unfreeze at epoch 2 of 2) in {wall:.1f} s wall: {cover[0].split(' ', 2)[2]}; "
          f"{vals}; best.npz written; --viz-interval 2 snapshots {snaps}; {card}", flush=True)


# The remaining CLIs and utils.

# The port's kernels as profile_step's families (utils/profiling.py: a
# kernel's base identifier) -> their launch counters' names; the fused second
# top-k (`topk_decode_kernel`) is a family of its own and counts in `topk`,
# as LAUNCHES counts it.
PROFILE_FAMILIES = {"stem_tc_kernel": "stem", "dw7x7_kernel": "dw7x7", "topk_kernel": "topk",
                    "topk_decode_kernel": "topk",
                    "s2d_wgmma_kernel": "s2dconv", "gemm_kernel": "bmm", "argmax_kernel": "argmax",
                    "nms_kernel": "nms", "mpbwd_vec_kernel": "mpbwd", "mpbwd_kernel": "mpbwd",
                    "dfl_boxes_kernel": "dfl_boxes",
                    "bn_moments_kernel": "bn_moments", "bn_moments_bwd_kernel": "bn_moments_bwd",
                    "tal_candidates_kernel": "tal_candidates", "tal_targets_kernel": "tal_targets"}
PROFILE_STEPS = 3
TRAIN_PROFILE_STEPS = 2
TRAIN_DEVICE_MS = 74.1  # PERF.md section 5: device time a training step by profile_step (74.06-74.13)
# The JAX package's SQA step QT-001 (sqa.yaml): make_learnable_coco sets of
# 240 (seed 0) and 60 held-out (seed 777) images at 160 px, yolov10n trained
# at batch 16 (bf16, augment, clip 1.0, 8 boxes), validated by the top-k
# decode, gated at held-out mAP50 0.2. QT-001 trains 30 epochs; this run
# trains 20 of them, for its time limit (its loss has flattened by then): a
# shortened QT-001, named so in what it prints.
QT001 = {"train": (240, 0), "val": (60, 777), "imgsz": 160, "epochs": 20, "batch": 16, "map50_min": 0.2}


# check_imports, then an import of every port module, with `jax`, `jaxlib`
# and the JAX package unimportable.
NO_JAX = (
    "import importlib, importlib.abc, pkgutil, sys\n"
    "class Hide(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'leanyolo_tpu', 'experiments'):\n"
    "            raise ModuleNotFoundError(name)\n"
    "sys.meta_path.insert(0, Hide())\n"
    "from leanyolo_tpu_torch.tools.check_imports import main\n"
    "main([])\n"
    "import leanyolo_tpu_torch as p\n"
    "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
    "for m in mods:\n"
    "    importlib.import_module(m)\n"
    "print(f'imported {len(mods)} port modules')\n")


def run_tool(module: str, args, ok=True) -> tuple:
    """`python -m leanyolo_tpu_torch.tools.<module> args`, as a user runs it:
    (stdout, stderr, wall seconds); fails unless it exits 0 (ok=True) or
    not (ok=False); ok=None leaves the exit to the caller's reading."""
    out, err, rc, wall = Job(tool_argv(module, args)).result()
    if ok is not None and (rc == 0) != ok:
        fail(f"{module} {list(args)}: rc {rc}, expected {'0' if ok else 'non-zero'}\nstdout "
             f"{out[-3000:]}\nstderr {err[-3000:]}")
    return out, err, wall


def run_at_once(cmds) -> list:
    """Run independent checks that time nothing, each an argv list, as
    processes at the same time: [(stdout, stderr, returncode)] in order."""
    return [r[:3] for r in wait_all([Job(c) for c in cmds])]


def tool_argv(module: str, args) -> list:
    return [sys.executable, "-m", f"leanyolo_tpu_torch.tools.{module}", *map(str, args)]


def profile_counts(tag: str, data: dict, out_dir: str, steps: int, want: dict) -> None:
    """Hold the port's kernels in profile_step's table (`data`, its JSON) to
    `want` launches a step, and the trace's whole counts to `want` x steps
    (the same trace summed over its steps); every other port kernel absent."""
    from leanyolo_tpu_torch.utils.profiling import summarize_trace

    if not data["plane"].startswith("cuda:0 (") or data["steps"] != steps:
        fail(f"profile_step {tag}: plane {data['plane']!r}, steps {data['steps']}")
    whole = {f.name: f.count for f in summarize_trace(out_dir, steps=1).families}
    per_step, ms, total = {}, {}, {}
    for f in data["families"]:
        name = PROFILE_FAMILIES.get(f["name"])
        if name is not None:
            per_step[name] = per_step.get(name, 0) + f["count"]
            ms[name] = ms.get(name, 0.0) + f["ms_per_step"]
            total[name] = total.get(name, 0) + whole[f["name"]]
    print(f"profile_step {tag}: the port's kernels a step (family counts, ms/step): "
          f"{ {n: (per_step[n], round(ms[n], 4)) for n in per_step} }; over the {steps} steps {total}", flush=True)
    if per_step != want or total != {n: k * steps for n, k in want.items()}:
        fail(f"profile_step {tag}: the port's kernels {per_step} a step ({total} in all), expected {want} a step")


def phase_profile_step(card: str, serving_profile: dict) -> None:
    """profile_step on the serving and the training step, alone on the card
    (item 14 of the module doc)."""
    with tempfile.TemporaryDirectory() as tmp:
        # a) profile_step on the serving path, both decodes, against the
        # serving step's profile in phase 5.
        common = ["--model", "yolov10s", "--imgsz", IMGSZ, "--batch-size", BATCH, "--dtype", "bf16", "--top", "12"]
        runs = {}
        for decode, want in (("topk", PER_REQUEST), ("nms", PER_REQUEST_NMS)):
            out_dir, js = os.path.join(tmp, f"prof_{decode}"), os.path.join(tmp, f"prof_{decode}.json")
            out, _, wall = run_tool("profile_step", common + ["--mode", "infer", "--fuse", "--decode", decode,
                                                              "--steps", PROFILE_STEPS, "--out-dir", out_dir,
                                                              "--json", js])
            with open(js) as f:
                runs[decode] = json.load(f)
            print(f"profile_step --mode infer --decode {decode} (yolov10s {IMGSZ} bf16 --fuse, batch {BATCH}, "
                  f"{PROFILE_STEPS} steps) in {wall:.1f} s wall; {card}:\n{out.rstrip()}", flush=True)
            profile_counts(f"infer {decode}", runs[decode], out_dir, PROFILE_STEPS, want)
        got, ref = runs["topk"]["total_ms_per_step"], serving_profile["total_ms"]
        gap = abs(got - ref) / ref
        fams = {f["name"]: f["ms_per_step"] for f in runs["topk"]["families"]}
        diffs = sorted(set(fams) | set(serving_profile["families"]),
                       key=lambda k: -abs(fams.get(k, 0.0) - serving_profile["families"].get(k, 0.0)))
        print(f"serving step device time: profile_step {got:.4f} ms/step against phase 5's profile {ref:.4f} "
              f"(key_averages' self device time), {gap * 100:.2f}% apart; the stem's family {fams['stem_tc_kernel']:.4f} "
              f"ms/step; {card}", flush=True)
        if not gap <= 0.10:
            fail(f"profile_step's serving step ({got:.4f} ms) and phase 5's profile ({ref:.4f} ms) differ by "
                 f"{gap * 100:.1f}%; the families that differ most (profile_step, phase 5): "
                 f"{[(k, fams.get(k, 0.0), serving_profile['families'].get(k, 0.0)) for k in diffs[:6]]}")

        # b) profile_step on the training step.
        out_dir, js = os.path.join(tmp, "prof_train"), os.path.join(tmp, "prof_train.json")
        out, _, wall = run_tool("profile_step", common + ["--mode", "train", "--steps", TRAIN_PROFILE_STEPS,
                                                          "--out-dir", out_dir, "--json", js])
        with open(js) as f:
            data = json.load(f)
        print(f"profile_step --mode train (yolov10s {IMGSZ} bf16, batch {BATCH}, {TRAIN_PROFILE_STEPS} steps) in "
              f"{wall:.1f} s wall; {card}:\n{out.rstrip()}", flush=True)
        profile_counts("train", data, out_dir, TRAIN_PROFILE_STEPS, {"mpbwd": 3, **BN_PER_STEP, **TAL_PER_STEP})
        print(f"training step device time: profile_step {data['total_ms_per_step']:.4f} ms/step beside PERF.md "
              f"section 5's {TRAIN_DEVICE_MS} ms; {card}", flush=True)


def start_qt001(tmp: str) -> dict:
    """The shortened QT-001's sets written under `tmp` and its train CLI
    started, to run beside the phases up to phase_tools, which reads it:
    {"sets", "run" (its out-dir), "job"}."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from synth_coco import make_learnable_coco

    sets = {}
    for part in ("train", "val"):
        n, s = QT001[part]
        sets[part] = make_learnable_coco(os.path.join(tmp, f"qt_{part}"), n_images=n, seed=s)
    run = os.path.join(tmp, "qt_run")
    job = Job(tool_argv("train", [
        "--model", "yolov10n", "--train-images", sets["train"][0], "--train-ann", sets["train"][1], "--imgsz",
        QT001["imgsz"], "--epochs", QT001["epochs"], "--batch-size", QT001["batch"], "--bf16", "--augment",
        "--grad-clip", "1.0", "--max-boxes", "8", "--out-dir", run]))
    return {"sets": sets, "run": run, "job": job}


def phase_tools(seed: int, card: str, tmp: str, qt: dict) -> None:
    """The remaining CLIs and utils on the card (item 14 of the module doc),
    profile_step apart; the shortened QT-001 (start_qt001) last."""
    import copy

    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor, YOLOv10, get_model, kernels
    from leanyolo_tpu_torch.data.coco import coco80_class_names
    from leanyolo_tpu_torch.engine.validator import validate_coco
    from leanyolo_tpu_torch.tools.convergence_gate import loss_curve_stats

    sets = qt["sets"]
    # d) A release-format yolov10n (random, BN calibrated on the held-out
    # images, scores spread) converted by the CLI, served against its
    # source, then the parity CLI on the held-out set labelled by it.
    from leanyolo_tpu_torch.data.dataset import CocoDetection

    ds = CocoDetection(*sets["val"], img_size=QT001["imgsz"])
    raw = [ds.load_image(i) for i in range(len(ds))]
    model = YOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(NC)], seed=seed + 15).cuda().eval()
    model = calibrate(model, torch.from_numpy(np.stack(raw)).cuda(), logits=VAL_LOGITS, var_scale=VAL_VAR_SCALE)
    pt, npz = os.path.join(tmp, "yolov10n.pt"), os.path.join(tmp, "yolov10n_coco.npz")
    write_release_file(release_state_dict(model, fused=False), pt)
    out, _, wall = run_tool("convert_official_weights", ["--model", "yolov10n", "--local-pt", pt, "--out", npz])
    if "missing 0" not in out or f"saved: {npz}" not in out:
        fail(f"convert_official_weights:\n{out}")
    names = coco80_class_names()
    loaded = get_model("yolov10n", weights=npz, class_names=names)
    src16 = copy.deepcopy(model)
    src16.load_state_dict({k: v if k.startswith("input_") else v.half().float()
                           for k, v in model.state_dict().items()})
    rng = np.random.RandomState(seed + 16)
    x32 = torch.from_numpy(rng.randint(0, 256, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.uint8)).cuda()
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        pred = Predictor(loaded, imgsz=IMGSZ, decode="topk", dtype="bfloat16", fuse=True, max_det=MAX_DET)
        ref = Predictor(src16, imgsz=IMGSZ, decode="topk", dtype="bfloat16", fuse=True, max_det=MAX_DET)
        launched, outs = [], []
        for p in (pred, ref):
            kernels.reset_launches()
            outs.append(p.run_batch(x32))
            torch.cuda.synchronize()
            launched.append({n: kernels.LAUNCHES[n] for n in PER_REQUEST})
        (dets, num), (want_dets, want_num) = outs
        maps, want_maps = pred.raw(x32), ref.raw(x32)
        torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    check_dets(dets, num, BATCH)
    same = (torch.equal(dets, want_dets) and torch.equal(num, want_num)
            and all(torch.equal(a, b) for lvl, w in zip(maps, want_maps) for a, b in zip(lvl, w)))
    print(f"convert_official_weights --local-pt (release-format yolov10n, fp16) in {wall:.1f} s: "
          f"{out.splitlines()[0]}; get_model(weights=<npz>) serves batch {BATCH} ({IMGSZ} px, bf16 folded, "
          f"launches {launched[0]}) bit-equal to the source module: {same}", flush=True)
    # yolov10n folds to its own counts (fewer bmm, more s2dconv than yolov10s): the source's.
    if not same or launched[0] != launched[1] or not all(launched[0].values()):
        fail("convert_official_weights: the converted checkpoint does not serve as its source does")
    del pred, ref, maps, want_maps

    pred32 = Predictor(loaded, imgsz=QT001["imgsz"], decode="topk", dtype="float32", max_det=MAX_DET)
    dets = []
    for s in range(0, len(raw), QT001["batch"]):
        dets += pred32.predict_images(raw[s:s + QT001["batch"]], apply_conf_filter=False)
    entries = ds.images
    anns, _ = self_label(dets, entries)
    cats = [{"id": c, "name": n} for c, n in zip(COCO_CAT_IDS, names)]
    ann80 = os.path.join(tmp, "qt_val_80.json")
    with open(ann80, "w") as f:
        json.dump({"images": entries, "annotations": anns, "categories": cats}, f)
    kw = dict(images_dir=sets["val"][0], ann_json=ann80, imgsz=QT001["imgsz"], batch_size=QT001["batch"])
    in_process = validate_coco(loaded, decode="topk", conf_thresh=0.001, iou_thresh=0.65, **kw)["map_50_95"]
    argv = ["--model", "yolov10n", "--weights", npz, "--images-dir", kw["images_dir"], "--ann-json", ann80,
            "--imgsz", kw["imgsz"], "--batch-size", kw["batch_size"]]
    t0 = time.perf_counter()
    (out, err, rc), (out_bad, err_bad, rc_bad) = run_at_once(
        [tool_argv("check_map_parity", argv + ["--official-map", repr(in_process)]),
         tool_argv("check_map_parity", argv + ["--official-map", repr(in_process + 0.05)])])
    wall = time.perf_counter() - t0
    if rc or not out.rstrip().endswith("PARITY OK"):
        fail(f"check_map_parity: rc {rc}\n{out}\n{err[-3000:]}")
    if not rc_bad or "PARITY FAILED" not in err_bad:
        fail(f"check_map_parity off by 0.05: rc {rc_bad}\n{out_bad}\n{err_bad}")
    print(f"check_map_parity on the held-out set self-labelled by the converted yolov10n ({len(anns)} labels "
          f"and crowd regions, 80 categories) against validate_coco in process (mAP50-95 {in_process!r}), both "
          f"runs at once in {wall:.1f} s: {out.strip().splitlines()[-2]} -> PARITY OK; with --official-map off "
          f"by 0.05: {err_bad.strip().splitlines()[-1]}", flush=True)

    # e) check_imports over the port as a user runs it, and again with
    # JAX hidden from the import system (this machine may have it): the
    # port's imports resolve without it, and every port module imports.
    import importlib.util

    (out, err, rc), (r_out, r_err, r_rc) = run_at_once([tool_argv("check_imports", []),
                                                         [sys.executable, "-c", NO_JAX]])
    print(f"check_imports over leanyolo_tpu_torch: {out.strip()}; with JAX hidden (installed here: "
          f"{importlib.util.find_spec('jax') is not None}): rc {r_rc}, {r_out.strip()}", flush=True)
    if (rc or r_rc or out != r_out.splitlines()[0] + "\n"
            or not out.rstrip().endswith("top-level imports resolvable")):
        fail(f"check_imports: the port's imports do not all resolve without JAX\n{err[-3000:]}\n{r_out}\n"
             f"{r_err[-3000:]}")

    # c) The shortened QT-001 through the port's train (started by
    # start_qt001), val and convergence_gate CLIs.
    out, err, rc, train_wall = qt["job"].result()
    if rc != 0:
        fail(f"shortened QT-001 train CLI: rc {rc}\nstdout {out[-3000:]}\nstderr {err[-3000:]}")
    run = qt["run"]
    with open(os.path.join(run, "history.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len(rows) != QT001["epochs"] or not np.isfinite([r["loss_total"] for r in rows]).all():
        fail(f"shortened QT-001 train CLI: history {rows}\n{out[-3000:]}")
    val_csv = os.path.join(tmp, "qt_val.csv")
    out, _, val_wall = run_tool("val", [
        "--model", "yolov10n", "--weights", os.path.join(run, "ckpt.npz"), "--images-dir", sets["val"][0],
        "--ann-json", sets["val"][1], "--imgsz", QT001["imgsz"], "--batch-size", QT001["batch"], "--decode",
        "topk", "--log-csv", val_csv])
    map_line = next(ln for ln in out.splitlines() if ln.startswith("mAP50-95="))
    gate, gate_err, _ = run_tool("convergence_gate", [
        "--history", os.path.join(run, "history.jsonl"), "--val-csv", val_csv, "--map50-min", QT001["map50_min"]],
        ok=None)
    stats = loss_curve_stats(rows)
    print(f"shortened QT-001 through the port (yolov10n {QT001['imgsz']} px, {QT001['epochs']} of its 30 epochs of "
          f"{QT001['train'][0]} images at batch {QT001['batch']}, bf16, augment, clip 1.0): train CLI "
          f"{train_wall:.1f} s wall (beside the train and transfer CLIs and this phase's checks), epoch s "
          f"{[r['time_s'] for r in rows]}; loss_total by epoch "
          f"{[round(r['loss_total'], 4) for r in rows]}; ratio {stats['ratio']:.4f}, decreasing "
          f"{stats['decreasing_frac']:.4f}; held-out ({QT001['val'][0]} images) {map_line} in {val_wall:.1f} s; "
          f"{card}\nconvergence_gate:\n{gate.rstrip()}\n{gate_err.rstrip()}", flush=True)
    if "mAP arm (STRICT, backend=cuda)" not in gate or not gate.rstrip().endswith("convergence gate: PASSED"):
        fail("shortened QT-001: the convergence gate did not pass on backend cuda")


# Drawing and export.
# dfl_boxes: the selected anchors' boxes (the export runs no dense DFL).
EXPORT_PER_CALL = {"stem": 1, "dw7x7": 2, "s2dconv": 2, "bmm": 45, "topk": 1, "argmax": 1, "nms": 0, "dfl_boxes": 1}
EXPORT_PER_CALL_NMS = {"stem": 1, "dw7x7": 2, "s2dconv": 2, "bmm": 45, "topk": 1, "argmax": 0, "nms": 1,
                       "dfl_boxes": 1}
BUCKETS = (320, 640)
EXPORT_RUNS = 10  # timed requests a median, artifact against live module and predictor
BF16_NMS_THRESHOLDS = (0.45, 0.451, 0.65)  # 0.451 rounds up in bf16
DIRECT_LEVELS = ((80, 80), (40, 40), (20, 20))


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds a call of fn() over n back-to-back calls after a
    warm-up: the host's own cost where the card keeps up."""
    import torch

    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
        return bool(torch.equal(a.view(view), b.view(view)))
    return bool(torch.equal(a, b))


def phase_dispatch(model, card: str) -> None:
    """The host cost of a kernel call through its operator (the dispatcher,
    then the wrapper's CUDA implementation) against the implementation
    called directly and against the binding's ext() call alone, in turns;
    then Predictor.run_batch wall times at batches 1 and 32."""
    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor
    from leanyolo_tpu_torch.kernels import _build, dwconv

    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.randn(1, 20, 20, 512, generator=g, device="cuda").bfloat16()
    w49 = dwconv.pack_weights(torch.randn(512, 1, 7, 7, generator=g, device="cuda")).bfloat16()
    b = torch.randn(512, generator=g, device="cuda").bfloat16()
    out, ext = torch.empty_like(x), _build.ext()
    calls = {"operator": lambda: dwconv.dw7x7_bias_silu(x, w49, b),
             "implementation": lambda: dwconv._dw7x7_cuda(x, w49, b),
             "ext": lambda: ext.dw7x7(x, w49, b, out)}
    us = {k: [] for k in calls}
    for k in ("operator", "implementation", "ext", "ext", "implementation", "operator"):
        us[k].append(host_us(calls[k]))
    us = {k: statistics.mean(v) for k, v in us.items()}
    pred = Predictor(model, imgsz=IMGSZ, decode="topk", dtype="bfloat16", fuse=True, max_det=MAX_DET)
    rng = np.random.RandomState(SEED + 14)
    reqs = {n: torch.from_numpy(rng.randint(0, 256, (n, IMGSZ, IMGSZ, 3)).astype(np.uint8)).cuda() for n in (1, BATCH)}
    walls = {n: wall_ms(lambda n=n: pred.run_batch(reqs[n])) for n in (1, BATCH)}
    calls_per_request = sum(PER_REQUEST.values())
    added_ms = calls_per_request * (us["operator"] - us["implementation"]) / 1e3
    share = added_ms / walls[1]
    print(f"dispatch cost (dw7x7 at [1,20,20,512] bf16, host us a call, mean of 2 runs of 2000 in turns): through "
          f"the operator {us['operator']:.2f}, its CUDA implementation called directly {us['implementation']:.2f}, "
          f"ext().dw7x7 alone {us['ext']:.2f}; the dispatcher adds {us['operator'] - us['implementation']:.2f} us a "
          f"call, the wrapper body {us['implementation'] - us['ext']:.2f}; {card}", flush=True)
    print(f"Predictor.run_batch wall (bf16 top-k folded, uint8 on the card, median of 20, host clock to the card's "
          f"finish): batch 1 {walls[1]:.4f} ms, batch 32 {walls[BATCH]:.4f} ms; {calls_per_request} operator calls "
          f"a request add {added_ms:.4f} ms, {share * 100:.2f}% of the batch-1 wall; {card}", flush=True)


def phase_nms_bf16(seed: int, records: dict) -> None:
    """K5's bf16 arithmetic mode against its plain version (keep masks and
    compaction bit-equal) at 8, 32 and 66 images a launch, and
    decode_direct_nms on bf16 maps, kernels against plain versions."""
    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.kernels import nms
    from leanyolo_tpu_torch.models.yolov10.decode import decode_direct_nms

    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    flips = 0
    for b in (8, BATCH, 66):
        for n in (63, 1000, 1500):
            for grid in (True, False):
                boxes, scores, cls = (t.bfloat16() for t in nms_inputs(g, b, n, grid))
                valid = torch.rand(b, n, generator=g, device="cuda") < 0.7
                for thresh in BF16_NMS_THRESHOLDS:
                    got, ref = nms.nms_keep(boxes, thresh, valid), nms.nms_keep_plain(boxes, thresh, valid)
                    torch.cuda.synchronize()
                    if not torch.equal(got, ref):
                        fail(f"nms bf16 keep mask disagrees with its plain version: b={b} n={n} grid={grid} "
                             f"iou={thresh}")
                    flips += int((got != nms.nms_keep(boxes.float(), thresh, valid)).sum())
            for class_wise in (False, True):
                for conf, iou in NMS_SETTINGS.values():
                    boxes, scores, cls = (t.bfloat16() for t in nms_inputs(g, b, n, False))
                    kw = dict(iou_thresh=iou, conf_thresh=conf, max_det=MAX_DET, class_wise=class_wise)
                    gd, gn = nms.nms_compact(boxes, scores, cls, **kw)
                    rd, rn = nms.nms_compact_plain(boxes, scores, cls, **kw)
                    torch.cuda.synchronize()
                    if not (same_bits(gd, rd) and torch.equal(gn, rn)):
                        fail(f"nms bf16 compaction disagrees with its plain version: b={b} n={n} "
                             f"class_wise={class_wise} conf={conf} iou={iou}")
        print(f"kernel nms bf16 mode [{b}, n] at n in (63, 1000, 1500): keep masks (grid and spread boxes, IoU "
              f"{BF16_NMS_THRESHOLDS}, valid masks) and dets/num (class-wise and not, both threshold settings) "
              f"bit-equal to the plain version", flush=True)
    print(f"kernel nms bf16 mode vs fp32 mode on the same bf16 candidates: {flips} keep decisions differ "
          f"(bf16 arithmetic is its own, not an upcast)", flush=True)
    # decode_direct_nms on bf16 maps (the legacy direct-offset layout).
    for b in (8, BATCH):
        maps = []
        for h, w in DIRECT_LEVELS:
            box = torch.randn(b, h, w, 4, generator=g, device="cuda") * 0.5
            logit = (torch.randn(b, h, w, NC, generator=g, device="cuda") * 3 - 4).mul(4).round().div(4)
            maps.append(torch.cat([box, logit], -1).bfloat16())
        kw = dict(num_classes=NC, strides=(8, 16, 32), conf_thresh=0.25, iou_thresh=0.45, max_det=MAX_DET)
        kernels.reset_launches()
        gd, gn = decode_direct_nms(maps, **kw)
        torch.cuda.synchronize()
        got = {k: kernels.LAUNCHES[k] for k in ("argmax", "topk", "nms")}
        with plain_kernels():
            rd, rn = decode_direct_nms(maps, **kw)
        torch.cuda.synchronize()
        if got != {"argmax": 1, "topk": 1, "nms": 1} or not (same_bits(gd, rd) and torch.equal(gn, rn)):
            fail(f"decode_direct_nms bf16 batch {b}: launches {got}, kernels and plain versions equal "
                 f"{same_bits(gd, rd) and torch.equal(gn, rn)}")
        print(f"decode_direct_nms on bf16 maps batch {b}: launches {got}, dets and num bit-equal to the plain "
              f"versions' (num {gn.tolist()[:8]})", flush=True)
    boxes, scores, cls = nms_inputs(g, BATCH, 1000, False)
    kw = dict(iou_thresh=0.45, conf_thresh=0.25, max_det=MAX_DET, class_wise=True)
    b16 = [t.bfloat16() for t in (boxes, scores, cls)]
    records["nms"]["bf16_mode"] = "decode_direct_nms on bf16 maps: bit-equal to its plain version"
    modes = {"bf16": lambda: nms.nms_compact(*b16, **kw), "fp32": lambda: nms.nms_compact(boxes, scores, cls, **kw)}
    ms = {k: [] for k in modes}
    for k in ("bf16", "fp32", "fp32", "bf16"):
        ms[k].append(events_ms(modes[k], inner=KERNEL_INNER))
    records["nms"]["bf16_ms"] = statistics.mean(ms["bf16"])
    records["nms"]["bf16_device_ms"] = device_ms(modes["bf16"])
    records["nms"]["bf16_plain_ms"] = events_ms(lambda: nms.nms_compact_plain(*b16, **kw), warmup=1, runs=3)
    print(f"kernel nms at [{BATCH},1000] class-wise, conf 0.25, IoU 0.45 (CUDA events, mean of 10 launches, median "
          f"of 20, in turns bf16, fp32, fp32, bf16): bf16 mode {ms['bf16']}, fp32 mode {ms['fp32']} ms; bf16 "
          f"device {records['nms']['bf16_device_ms']:.4f} ms; plain bf16 {records['nms']['bf16_plain_ms']:.3f} ms",
          flush=True)


def check_artifact(art, fn, xs: dict, per_call: dict, label: str) -> None:
    """The artifact at each batch of xs: bit-equal to the live module, with
    per_call launches of each kernel (the bf16 routes for stem, s2dconv, bmm)."""
    import torch
    from leanyolo_tpu_torch import kernels

    for b, x in xs.items():
        kernels.reset_launches()
        got = art(x)
        torch.cuda.synchronize()
        counts = {k: kernels.LAUNCHES[k] for k in per_call}
        routes = {r: kernels.LAUNCHES[r] for r in NEW_ROUTES}
        with torch.no_grad():
            ref = fn(x)
        torch.cuda.synchronize()
        if counts != per_call or any(routes[r] != per_call[of] for r, of in NEW_ROUTES.items()):
            fail(f"{label} artifact batch {b}: launches {counts}, bf16 routes {routes}; expected {per_call}")
        if not (same_bits(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            fail(f"{label} artifact batch {b}: differs from the live build_serving_fn")
        if tuple(got[0].shape) != (b, MAX_DET, 6) or not bool(torch.isfinite(got[0]).all()):
            fail(f"{label} artifact batch {b}: dets {tuple(got[0].shape)}")
        print(f"{label} artifact batch {b}: launches {counts} (bf16 routes {routes}); dets and num bit-equal to "
              f"the live module; num {got[1].tolist()[:8]}", flush=True)


def phase_export(model, seed: int, card: str) -> None:
    """The serving export on the card (the module doc's item 12)."""
    import tempfile

    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor
    from leanyolo_tpu_torch.export import serving as S
    from leanyolo_tpu_torch.models.yolov10.decode import postprocess_to_original
    from leanyolo_tpu_torch.ops.letterbox import choose_bucket, letterbox

    rng = np.random.RandomState(seed + 11)
    u8 = {b: rng.randint(0, 256, (b, IMGSZ, IMGSZ, 3)).astype(np.uint8) for b in (1, 8, BATCH)}
    xs = {b: torch.from_numpy(a.astype(np.float32)).cuda() for b, a in u8.items()}
    with tempfile.TemporaryDirectory() as tmp:
        for decode, per_call in (("topk", EXPORT_PER_CALL), ("nms", EXPORT_PER_CALL_NMS)):
            label = f"export bf16 {decode}"
            fn, _ = S.build_serving_fn(model, imgsz=IMGSZ, decode=decode, dtype="bf16", conf=0.25, iou=0.45,
                                       max_dets=MAX_DET)
            t0 = time.perf_counter()
            ep = S.export_program(fn)
            t1 = time.perf_counter()
            path = os.path.join(tmp, f"yolov10s_{decode}.pt2")
            torch.export.save(ep, path)
            t2 = time.perf_counter()
            art = S.load_exported(path)
            t3 = time.perf_counter()
            packed = [k for k in ep.state_dict if k.endswith(("stem_w0p", "stem_w1p", ".wt", "w_s2d", "w49"))]
            packed += [k for k in ep.constants if k.endswith(("stem_w0p", "stem_w1p", ".wt", "w_s2d", "w49"))]
            print(f"{label}: export {t1 - t0:.2f} s, save {t2 - t1:.2f} s ({os.path.getsize(path) / 2**20:.1f} MiB), "
                  f"load {t3 - t2:.2f} s; the program carries {len(packed)} packed kernel weights (stem_w0p, "
                  f"stem_w1p, wt, w_s2d, w49)", flush=True)
            check_artifact(art, fn, xs, per_call, label)
            pred = Predictor(model, imgsz=IMGSZ, decode=decode, dtype="bfloat16", fuse=True, max_det=MAX_DET)
            for b in (BATCH, 1):
                xb = torch.from_numpy(u8[b]).cuda()
                runs = {"artifact": lambda: art(xs[b]), "live": lambda: fn(xs[b]), "predictor": lambda: pred.run_batch(xb)}
                ms = {k: [] for k in runs}
                for k in ("artifact", "live", "predictor", "predictor", "live", "artifact"):
                    ms[k].append(events_ms(runs[k], runs=EXPORT_RUNS))
                print(f"{label} request ms at batch {b} (CUDA events, median of {EXPORT_RUNS} from an idle card, two "
                      f"runs in "
                      f"turns): artifact {ms['artifact']}, live build_serving_fn {ms['live']}, Predictor.run_batch "
                      f"{ms['predictor']}; {card}", flush=True)
            dev = [device_ms(lambda: art(xs[BATCH]), reps=3), device_ms(lambda: fn(xs[BATCH]), reps=3),
                   device_ms(lambda: fn(xs[BATCH]), reps=3), device_ms(lambda: art(xs[BATCH]), reps=3)]
            print(f"{label} device ms at batch {BATCH} (profiler, 3 calls, in turns artifact, live, live, "
                  f"artifact): {[round(v, 4) for v in dev]}; {card}", flush=True)
            del fn, ep, art, pred
            torch.cuda.empty_cache()

        # fp32: the artifact on the card against the CPU port's live module, on
        # a request like make_model's calibration images (at other sizes the
        # calibrated net's scores saturate and no rank is decided).
        path = S.export_serving(model, os.path.join(tmp, "fp32"), imgsz=IMGSZ, max_dets=MAX_DET)
        got = S.load_exported(path)(xs[1])
        with torch.no_grad():
            ref = S.build_serving_fn(model, imgsz=IMGSZ, max_dets=MAX_DET, device="cpu")[0](xs[1].cpu())
        gd, gn = got[0].cpu().numpy()[0], got[1].cpu()
        rd, rn = ref[0].numpy()[0], ref[1]
        # The top 300 of 8,400 scores lie closer together than fp32 noise, so
        # rows are matched, not compared by rank: each CPU row to a distinct
        # card row of its class within 1e-3 of score and 1e-3 of the image in
        # box; only rows at the cut (within 1e-3 of the last score) may miss.
        used, missed = np.zeros(len(gd), bool), []
        for i, r in enumerate(rd):
            near = (~used & (gd[:, 5] == r[5]) & (np.abs(gd[:, 4] - r[4]) <= 1e-3)
                    & (np.abs(gd[:, :4] - r[:4]).max(1) <= 1e-3 * IMGSZ))
            if near.any():
                used[np.flatnonzero(near)[np.abs(gd[near, :4] - r[:4]).max(1).argmin()]] = True
            else:
                missed.append(i)
        at_cut = all(rd[i, 4] - rd[-1, 4] <= 1e-3 for i in missed)
        ok = torch.equal(gn, rn) and at_cut and len(missed) <= 10
        print(f"export fp32 top-k at [1,{IMGSZ},{IMGSZ},3], card artifact vs the CPU port's live module: num "
              f"{gn.tolist()} vs {rn.tolist()}; {len(rd) - len(missed)} of {len(rd)} CPU rows matched one to one by "
              f"a card row of their class within 1e-3 of score and 1e-3 of {IMGSZ} px of box, the {len(missed)} "
              f"others at the cut {at_cut}", flush=True)
        if not ok:
            fail("export fp32: the card's artifact disagrees with the CPU port")

        # Bucketed: mixed-size images through BucketedServing against the live module per bucket.
        t0 = time.perf_counter()
        mpath = S.export_serving_bucketed(model, os.path.join(tmp, "buckets"), sizes=BUCKETS, dtype="bf16",
                                          max_dets=MAX_DET)
        t_b = time.perf_counter() - t0
        sizes = ((300, 200), (480, 640), (1080, 1920), (250, 320), (640, 427))
        imgs = [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in sizes]
        served = S.BucketedServing(mpath).predict_images(imgs)
        groups = {}
        for i, img in enumerate(imgs):
            groups.setdefault(choose_bucket(img.shape[:2], BUCKETS, max(BUCKETS)), []).append(i)
        for size, idxs in groups.items():
            fn = S.build_serving_fn(model, imgsz=size, dtype="bf16", max_dets=MAX_DET)[0]
            lbs = [letterbox(imgs[i], size) for i in idxs]
            x = torch.from_numpy(np.stack([lb.astype(np.float32) for lb, _, _ in lbs])).cuda()
            with torch.no_grad():
                dets, num = fn(x)
            ref = postprocess_to_original(dets, num, [(g_, p_, imgs[i].shape[:2]) for (_, g_, p_), i in zip(lbs, idxs)],
                                          decode="topk", conf_thresh=0.25, apply_conf_filter=True)
            for i, r in zip(idxs, ref):
                if not (served[i].shape == r.shape and np.array_equal(served[i], r)):
                    fail(f"bucketed serving: image {imgs[i].shape[:2]} (bucket {size}) differs from the live module")
        print(f"export bucketed bf16 top-k {BUCKETS}: exported in {t_b:.2f} s; {len(imgs)} images of sizes "
              f"{list(sizes)} served in buckets {dict((s_, len(v)) for s_, v in groups.items())}, boxes per image "
              f"{[len(d) for d in served]}, each equal to the live module of its bucket", flush=True)


def phase_infer_cli(model, seed: int, card: str) -> None:
    """The inference CLI in a subprocess and update_demo_viz in process, on
    the card, from a checkpoint of `model`."""
    import tempfile

    import numpy as np
    from PIL import Image
    from leanyolo_tpu_torch import Predictor, get_model
    from leanyolo_tpu_torch.data.coco import coco80_class_names
    from leanyolo_tpu_torch.data.dataset import read_rgb
    from leanyolo_tpu_torch.models.registry import save_checkpoint
    from leanyolo_tpu_torch.tools import update_demo_viz

    rng = np.random.RandomState(seed + 15)
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "yolov10s.npz")
        save_checkpoint(model, npz)
        src, out = os.path.join(tmp, "src"), os.path.join(tmp, "out")
        os.makedirs(src)
        shapes = ((480, 640), (640, 427), (300, 500))
        for i, (h, w) in enumerate(shapes):
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            img[h // 4:h // 2, w // 4:w // 2] = rng.randint(0, 256, 3)
            Image.fromarray(img).save(os.path.join(src, f"img{i}.jpg"), quality=90)
        with open(os.path.join(src, "broken.jpg"), "wb") as f:
            f.write(b"not an image")
        cmd = [sys.executable, "-m", "leanyolo_tpu_torch.tools.infer", "--source", src, "--model", "yolov10s",
               "--weights", npz, "--imgsz", str(IMGSZ), "--decode", "nms", "--dtype", "bf16", "--conf", "0.25",
               "--save-dir", out]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"infer CLI: rc {r.returncode}\nstdout {r.stdout[-2000:]}\nstderr {r.stderr[-4000:]}")
        lines = r.stdout.splitlines()
        names = coco80_class_names()
        pred = Predictor(get_model("yolov10s", weights=npz, class_names=names), imgsz=IMGSZ, decode="nms",
                         conf_thresh=0.25, dtype="bf16")
        want, n_boxes = [], 0
        for i in range(len(shapes)):
            name = f"img{i}.jpg"
            dets = pred.predict_images([read_rgb(os.path.join(src, name))])[0]
            n_boxes += len(dets)
            for d in dets:
                x1, y1, x2, y2, score, c = d[:6]
                want.append(f"{name}: {names[int(c)]} ({int(c)}) {score:.3f} [{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}]")
            want.append(f"saved: {os.path.join(out, name)} ({len(dets)} detections)")
        got = [ln for ln in lines if not ln.startswith("skip unreadable")]
        skipped = [ln for ln in lines if ln.startswith("skip unreadable")]
        written = sorted(os.listdir(out))
        shapes_ok = all(np.asarray(Image.open(os.path.join(out, f"img{i}.jpg"))).shape == hw + (3,)
                        for i, hw in enumerate(shapes))
        print(f"infer CLI (python -m leanyolo_tpu_torch.tools.infer, bf16 NMS, 3 JPEGs and an unreadable file) in "
              f"{wall:.1f} s: {n_boxes} box lines equal to Predictor.predict_images in process {got == want}; "
              f"skipped {len(skipped)}; drawn images {written} at their own sizes {shapes_ok}; {card}", flush=True)
        if got != want or len(skipped) != 1 or written != [f"img{i}.jpg" for i in range(len(shapes))] or not shapes_ok:
            fail(f"infer CLI: lines\n{chr(10).join(got[:12])}\nexpected\n{chr(10).join(want[:12])}")
        demo = os.path.join(tmp, "demo_viz.jpg")
        update_demo_viz.main(["--model", "yolov10s", "--weights", npz, "--out", demo])
        if np.asarray(Image.open(demo)).shape != (480, 640, 3):
            fail("update_demo_viz: no 480x640 image written")
        print("update_demo_viz on the card: the synthetic scene drawn and written (480x640)", flush=True)


# Phase 13: data parallelism, one process a card (leanyolo_tpu_torch/parallel/).
DP_SEED = 13  # added to SEED: the model, the batch and the augmentation draws of the phase
DP_WARMUP, DP_TIMED, DP_PAIR_TIMED = 3, 6, 3


@contextlib.contextmanager
def deterministic():
    """cuDNN and PyTorch on deterministic algorithms (DETERMINISTIC_CLI's
    settings; CUBLAS_WORKSPACE_CONFIG is set by the process's parent)."""
    import torch

    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[0], saved[1]
        torch.use_deterministic_algorithms(saved[2])


def dp_step(tr, batch, seed: int, probe: bool = False) -> dict:
    """One train step (forward_backward, then optimizer_step) with the
    augmentation generator seeded from `seed` (on the card, whatever the
    trainer's device, so a CPU step draws the card's numbers): the global
    losses, the gradients before the clip and the state after the step, on
    the host; with `probe`, also the input of SPPF's max pools."""
    import torch

    seen = []
    hook = tr.model.backbone.sppf9.cv1.register_forward_hook(lambda m, a, o: seen.append(o.detach().cpu())) \
        if probe else None
    losses = tr.forward_backward(batch, torch.Generator(device="cuda").manual_seed(seed))
    if hook is not None:
        hook.remove()
    grads = {n: p.grad.detach().cpu().clone() for n, p in tr.model.named_parameters() if p.grad is not None}
    tr.optimizer_step()
    tr.global_step += 1
    torch.cuda.synchronize()
    out = {"losses": {k: float(v) for k, v in losses.items()}, "grads": grads,
           "state": {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}}
    if probe:
        out["sppf_in"] = seen[0]
    return out


@contextlib.contextmanager
def box_pool_backward():
    """SPPF's max-pool backward swapped for an average pool's (each window's
    gradient spread evenly over it) in both runs of a comparison: the max
    pool routes a window's gradient to its argmax, which a change in the
    last bits of its input can move to a near-tied neighbour (pool_flips),
    so that comparison cannot tell the data-parallel machinery from that
    routing; with the box backward every gradient is a continuous function
    of the inputs. For the comparison only, as plain_kernels is."""
    import torch.nn.functional as F
    from leanyolo_tpu_torch.kernels import mpbwd

    saved = mpbwd.mpbwd
    mpbwd.mpbwd = lambda x, dy, k=5: F.avg_pool2d(dy.permute(0, 3, 1, 2), k, 1, k // 2,
                                                  count_include_pad=True).permute(0, 2, 3, 1).contiguous()
    try:
        yield
    finally:
        mpbwd.mpbwd = saved


#: Parameters whose gradient reaches them through SPPF's max pools (the
#: backbone up to SPPF's first conv): the pools' routing moves them.
def behind_pools(name: str) -> bool:
    return name.startswith("backbone.") and not name.startswith(("backbone.psa10.", "backbone.sppf9.cv2."))


def pool_flips(a, b) -> list:
    """For SPPF's three chained 5x5 max pools (stride 1, same padding), the
    windows whose argmax differs between inputs a and b [B, C, H, W]
    (torch's max_pool2d indices): where it differs, the backward routes the
    window's gradient to another element."""
    import torch.nn.functional as F

    flips = []
    for _ in range(3):
        a, ia = F.max_pool2d(a, 5, 1, 2, return_indices=True)
        b, ib = F.max_pool2d(b, 5, 1, 2, return_indices=True)
        flips.append(int((ia != ib).sum()))
    return flips


def rel_gap(a: dict, b: dict, floor: float = 0.0) -> float:
    """The largest max|a - b| over the tensors of two dicts, each over its
    tensor's max|b| (at least `floor`)."""
    return max(max_err(a[k], b[k]) / max(floor, 1e-30, float(b[k].float().abs().max())) for k in b)


def grad_gap(got: dict, ref: dict) -> float:
    """The largest max|got - ref| of two steps' gradients over that tensor's
    max|ref|, as tests/test_torch_train.py holds them: a tensor whose
    gradient is rounding noise (max|ref| under 1e-4 of the largest tensor's,
    e.g. a BN bias feeding straight into a batch-stat BN) has no scale of its
    own and counts only if `got` leaves that noise level (then inf)."""
    if got.keys() != ref.keys():
        return float("inf")
    gmax = max(float(g.abs().max()) for g in ref.values())
    worst = 0.0
    for k, g in ref.items():
        scale = float(g.abs().max())
        if scale <= 1e-4 * gmax:
            if float(got[k].abs().max()) > 1e-4 * gmax:
                return float("inf")
            continue
        worst = max(worst, max_err(got[k], g) / scale)
    return worst


def grad_l2(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over every gradient element of two steps."""
    num = sum(float(((got[k].double() - r.double()) ** 2).sum()) for k, r in ref.items())
    return (num / sum(float((r.double() ** 2).sum()) for r in ref.values())) ** 0.5


def grad_gap_global(got: dict, ref: dict) -> float:
    """The largest max|got - ref| of two steps' gradients over the largest
    tensor's max|ref| (the bf16 rule: bf16 gradients of a tensor can be all
    rounding, so each is read against the step's scale)."""
    gmax = max(float(g.abs().max()) for g in ref.values())
    return max(max_err(got[k], g) for k, g in ref.items()) / gmax if got.keys() == ref.keys() else float("inf")


def grad_report(got: dict, ref: dict, n: int = 4) -> str:
    """The n tensors with a scale of their own (grad_gap's) furthest from
    `ref` by max|got - ref| over their own max|ref|, each with that ratio,
    its gap over the largest tensor's max|ref| and its scale over it."""
    gmax = max(float(g.abs().max()) for g in ref.values())
    rows = sorted(((max_err(got[k], g) / max(1e-30, float(g.abs().max())), max_err(got[k], g) / gmax,
                    float(g.abs().max()) / gmax, k) for k, g in ref.items()
                   if float(g.abs().max()) > 1e-4 * gmax), reverse=True)[:n]
    return "; ".join(f"{k}: {r:.3g} of its scale, {a:.3g} of the largest, scale {sc:.3g} of the largest"
                     for r, a, sc, k in rows)


def dp_rank(argv) -> int:
    """A rank of phase 13: python3 chip_smoke.py --rank R --world W --port P
    --task world1|pair --root DIR [--after FILE]. 'world1': one NCCL rank,
    the mesh step against the plain step and both timed (once FILE exists);
    'pair': two ranks (NCCL on two
    cards, or gloo on the one card), the data-parallel step, the predictor
    on a mesh and the sharded validation. Saves what it saw under DIR."""
    import argparse
    import copy
    from types import SimpleNamespace

    p = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--task", choices=("world1", "pair"), required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--after", default=None, help="a file whose existence the timed steps wait for")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from leanyolo_tpu_torch import Predictor, TrainConfig, Trainer, YOLOv10, get_model, kernels
    from leanyolo_tpu_torch.data.coco import coco80_class_names
    from leanyolo_tpu_torch.engine.validator import validate_coco
    from leanyolo_tpu_torch.kernels import _build
    from leanyolo_tpu_torch.parallel.distributed import init_distributed, process_local_slice
    from leanyolo_tpu_torch.parallel.mesh import make_mesh

    _build.ext()  # built by the parent: this loads it
    if torch.cuda.device_count() >= args.world:
        init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank, device="cuda")
    else:  # NCCL refuses two ranks on one card
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}", world_size=args.world,
                                rank=args.rank)
    mesh = make_mesh()
    seed = SEED + DP_SEED
    model = YOLOv10.create("yolov10s", class_names=[f"c{i}" for i in range(NC)], seed=seed)
    batch = train_batch(np.random.RandomState(seed), BATCH, IMGSZ, "cuda")
    cfgs = {d: TrainConfig(bf16=d == "bf16", augment=True, grad_clip=1.0, steps_per_epoch=1000)
            for d in ("fp32", "bf16")}
    out = {"backend": dist.get_backend(), "card": torch.cuda.current_device()}
    say = lambda msg: print(f"{msg}; {dist.get_backend()}, rank {args.rank}/{args.world} on cuda:"
                            f"{torch.cuda.current_device()}", flush=True)

    def timed(tr, gen):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tr.train_step(rows_batch, gen)
        end.record()
        return start, end

    if args.task == "world1":
        rows_batch = batch
        for d in ("fp32", "bf16"):
            with deterministic():
                plain = dp_step(Trainer(copy.deepcopy(model), cfgs[d]), batch, seed, probe=d == "fp32")
                torch.cuda.empty_cache()
                kernels.reset_launches()
                meshed = dp_step(Trainer(copy.deepcopy(model), cfgs[d], mesh=mesh), batch, seed)
                mpbwd = kernels.LAUNCHES["mpbwd"]
                tal_launches = [kernels.LAUNCHES[k] for k in TAL_PER_STEP]
            torch.cuda.empty_cache()
            same = (plain["losses"] == meshed["losses"] and plain["grads"].keys() == meshed["grads"].keys()
                    and all(torch.equal(plain["grads"][k], meshed["grads"][k]) for k in plain["grads"])
                    and all(torch.equal(plain["state"][k], meshed["state"][k]) for k in plain["state"]))
            out[d] = {"plain": plain, "bit_equal": same, "mpbwd": mpbwd, "tal": tal_launches}
            if d == "fp32":  # the box-backward comparison's references, on the card and on the CPU
                on_cpu = SimpleNamespace(images=batch.images.cpu(), gt_labels=batch.gt_labels.cpu(),
                                         gt_boxes=batch.gt_boxes.cpu(), gt_mask=batch.gt_mask)
                with deterministic(), box_pool_backward():
                    out[d]["box"] = dp_step(Trainer(copy.deepcopy(model), cfgs[d]), batch, seed)
                    t0 = time.perf_counter()
                    out[d]["box_cpu"] = dp_step(Trainer(copy.deepcopy(model), cfgs[d], device="cpu"), on_cpu, seed)
                say(f"the one-process fp32 step on the CPU (the box-backward comparison's reference) took "
                    f"{time.perf_counter() - t0:.1f} s")
            say(f"world-1 mesh step {d}: loss {meshed['losses']['total']!r} against the plain step's "
                f"{plain['losses']['total']!r}; bit-equal losses, gradients, statistics and parameters: {same}; "
                f"worst gradient gap {grad_gap(meshed['grads'], plain['grads'])!r}; mpbwd launches {mpbwd}")
        if args.after:  # the job started beside this one ends first, so the timing has the card alone
            deadline = time.monotonic() + 900
            while not os.path.exists(args.after) and time.monotonic() < deadline:
                time.sleep(0.1)
        tp, tm = Trainer(copy.deepcopy(model), cfgs["bf16"]), Trainer(copy.deepcopy(model), cfgs["bf16"], mesh=mesh)
        gp, gm = (torch.Generator(device="cuda").manual_seed(seed) for _ in range(2))
        for _ in range(DP_WARMUP):
            timed(tp, gp), timed(tm, gm)
        ev = {"plain": [], "mesh": []}
        for i in range(DP_TIMED):  # in turns: plain, mesh, mesh, plain, ...
            for name, tr, g in ((("plain", tp, gp), ("mesh", tm, gm)) if i % 2 == 0 else
                                (("mesh", tm, gm), ("plain", tp, gp))):
                ev[name].append(timed(tr, g))
        torch.cuda.synchronize()
        ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in ev.items()}
        out["ms"] = {k: statistics.median(v) for k, v in ms.items()}
        # The host cost of one collective: a BN's moments (2 x 512 fp32) all-reduced 200 times.
        t = torch.zeros(1024, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(t)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        out["allreduce_host_us"] = host_us
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                tm.train_step(batch, gm)
            torch.cuda.synchronize()
        events = prof.key_averages()
        host = {e.key: e.count // 2 for e in events if e.device_type.name == "CPU" and e.key.startswith("c10d::")}
        dev = [e for e in events if e.device_type.name == "CUDA" and "nccl" in e.key.lower()]
        out["collectives"] = {"host": host, "device_calls": sum(e.count for e in dev) // 2,
                              "device_ms": sum(e.self_device_time_total for e in dev) / 2 / 1e3}
        say(f"world-1 yolov10s {IMGSZ} bf16 batch {BATCH} (augment, clip 1.0): ms/step median of {DP_TIMED} in "
            f"turns, plain {out['ms']['plain']!r} (all {[round(v, 4) for v in ms['plain']]}), mesh "
            f"{out['ms']['mesh']!r} (all {[round(v, 4) for v in ms['mesh']]}); collectives a mesh step: host "
            f"{host}, {out['collectives']['device_calls']} NCCL kernels, {out['collectives']['device_ms']!r} ms "
            f"device; one all-reduce of 1,024 fp32 costs the host {host_us:.2f} us (mean of 200)")
    else:
        rows = process_local_slice(BATCH)
        rows_batch = SimpleNamespace(images=batch.images[rows], gt_labels=batch.gt_labels[rows],
                                     gt_boxes=batch.gt_boxes[rows], gt_mask=batch.gt_mask[rows])
        for d in ("fp32", "bf16"):
            with deterministic():
                kernels.reset_launches()
                out[d] = dp_step(Trainer(copy.deepcopy(model), cfgs[d], mesh=mesh), rows_batch, seed,
                                 probe=d == "fp32")
                out[d]["mpbwd"] = kernels.LAUNCHES["mpbwd"]
                out[d]["tal"] = [kernels.LAUNCHES[k] for k in TAL_PER_STEP]
                if d == "fp32":
                    with box_pool_backward():
                        out["fp32_box"] = dp_step(Trainer(copy.deepcopy(model), cfgs[d], mesh=mesh), rows_batch,
                                                  seed)
            torch.cuda.empty_cache()
        tm = Trainer(copy.deepcopy(model), cfgs["bf16"], mesh=mesh)
        gm = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(2):
            timed(tm, gm)
        ev = [timed(tm, gm) for _ in range(DP_PAIR_TIMED)]
        torch.cuda.synchronize()
        out["ms"] = [s.elapsed_time(e) for s, e in ev]
        del tm
        torch.cuda.empty_cache()
        say(f"data-parallel step bf16, {BATCH // args.world} rows of {BATCH}: ms/step "
            f"{[round(v, 4) for v in out['ms']]} (median {statistics.median(out['ms'])!r})")

        out["predict"] = {}
        for name, kw in (("topk", {}), ("nms", dict(decode="nms", conf_thresh=NMS_SETTINGS["infer"][0],
                                                    iou_thresh=NMS_SETTINGS["infer"][1], class_wise_nms=True))):
            pd = Predictor(model, imgsz=IMGSZ, dtype="bfloat16", fuse=True, mesh=mesh, **kw)
            pl = Predictor(model, imgsz=IMGSZ, dtype="bfloat16", fuse=True, **kw)
            torch.cuda.synchronize()
            kernels.reset_launches()
            dets, num = pd.run_batch(batch.images)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            ldets, lnum = pl.run_batch(batch.images[rows])
            out["predict"][name] = {"launches": launches, "dets": dets.cpu(), "num": num.cpu(),
                                    "same_as_local": torch.equal(dets[rows], ldets) and torch.equal(num[rows], lnum)}
            del pd, pl
        with open(os.path.join(args.root, "val.json")) as f:
            v = json.load(f)
        vm = get_model("yolov10s", weights=v["npz"], class_names=coco80_class_names())
        kernels.reset_launches()
        st = validate_coco(vm, images_dir=v["images_dir"], ann_json=v["ann"], imgsz=IMGSZ, batch_size=VAL_BATCH,
                           decode="topk", workers=8, shard=(args.rank, args.world),
                           save_detections=v["dets"] if args.rank == 0 else None)
        torch.cuda.synchronize()
        out["val"] = {"stats": st, "launches": dict(kernels.LAUNCHES)}
    torch.save(out, os.path.join(args.root, f"{args.task}_rank{args.rank}.pt"))
    dist.destroy_process_group()
    return 0


def same_detections(a: list, b: list):
    """Saved COCO detections of one run against another's, image by image:
    (the same images and counts a category, the largest box gap in px and
    score gap of rows matched one to one: in score order, each row of `a` to
    the nearest unmatched row of `b` of its category)."""
    import numpy as np

    def by_image(res):
        out = {}
        for r in res:
            out.setdefault(r["image_id"], []).append([r["category_id"], r["score"], *r["bbox"]])
        return {k: np.asarray(v, np.float64) for k, v in out.items()}

    ia, ib = by_image(a), by_image(b)
    if sorted(ia) != sorted(ib) or any(sorted(ia[k][:, 0]) != sorted(ib[k][:, 0]) for k in ia):
        return False, float("inf"), float("inf")
    box_gap = score_gap = 0.0
    for k, rows in ia.items():
        pool = ib[k]
        free = np.ones(len(pool), bool)
        for r in rows[np.argsort(-rows[:, 1], kind="stable")]:
            cost = np.abs(pool[:, 2:] - r[2:]).max(axis=1) + np.abs(pool[:, 1] - r[1])
            cost[~free | (pool[:, 0] != r[0])] = np.inf
            j = int(np.argmin(cost))
            free[j] = False
            box_gap = max(box_gap, float(np.abs(pool[j, 2:] - r[2:]).max()))
            score_gap = max(score_gap, float(abs(pool[j, 1] - r[1])))
    return True, box_gap, score_gap


def phase_parallel(model, seed: int, card: str) -> None:
    """Data parallelism on the card (item 13 of the module doc)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from leanyolo_tpu_torch import kernels
    from leanyolo_tpu_torch.engine.validator import validate_coco
    from leanyolo_tpu_torch.parallel.dryrun import check_ranks, spawn_ranks

    n_cards = torch.cuda.device_count()
    print(f"parallel: torch.cuda.device_count() {n_cards}, torch.cuda.nccl.version() {torch.cuda.nccl.version()}",
          flush=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with tempfile.TemporaryDirectory() as tmp:
        pair_done = os.path.join(tmp, "pair_done")

        def launch(task: str, world: int, port: int, extra=()):
            """The task's ranks: (results, wall s); the pair then leaves pair_done."""
            t0 = time.perf_counter()
            try:
                results = spawn_ranks(lambda r: [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank",
                                                 str(r), "--world", str(world), "--port", str(port), "--task", task,
                                                 "--root", tmp, *extra], world, timeout=900, env=env)
            finally:
                if task == "pair":
                    open(pair_done, "w").close()
            return results, time.perf_counter() - t0

        def report(task: str, world: int, results, wall):
            for r, (_, out, _) in enumerate(results):
                for line in out.splitlines():
                    print(f"  [{task} rank {r}] {line}", flush=True)
            try:
                check_ranks(results, f"parallel {task}")
            except RuntimeError as e:
                fail(str(e))
            print(f"parallel {task}: {world} rank(s) done in {wall:.1f} s (start-up included, both tasks at once)",
                  flush=True)
            return [torch.load(os.path.join(tmp, f"{task}_rank{r}.pt"), weights_only=True) for r in range(world)]

        # One NCCL rank (the mesh step bit-equal to the plain step, both
        # timed once the pair has ended) and two ranks (NCCL on two cards, or
        # gloo on the one card), at once: the pair once the sharded
        # validation's set is labelled, as item 10 labels it.
        ports = free_ports(2)
        with ThreadPoolExecutor(2) as pool:
            w1_run = pool.submit(launch, "world1", 1, ports[0], ("--after", pair_done))
            try:
                images_dir, _, ann, _, _, _, npz, loaded, pred32 = labelled_val_set(model, seed, tmp)
                del pred32
                torch.cuda.empty_cache()
                with open(os.path.join(tmp, "val.json"), "w") as f:
                    json.dump({"images_dir": images_dir, "ann": ann, "npz": npz,
                               "dets": os.path.join(tmp, "dets2.json")}, f)
            except BaseException:
                open(pair_done, "w").close()  # the one rank's timing waits for nothing more
                raise
            pair_run = pool.submit(launch, "pair", 2, ports[1])
            w1_run, pair_run = w1_run.result(), pair_run.result()
        (w1,) = report("world1", 1, *w1_run)
        for d in ("fp32", "bf16"):
            if not w1[d]["bit_equal"] or w1[d]["mpbwd"] != 3 or w1[d]["tal"] != [2, 2]:
                fail(f"parallel world-1 {d}: mesh step bit-equal {w1[d]['bit_equal']}, mpbwd {w1[d]['mpbwd']}, "
                     f"tal {w1[d]['tal']} (2 + 2)")
        over = w1["ms"]["mesh"] / w1["ms"]["plain"] - 1
        print(f"parallel world-1 (NCCL, one rank): bf16 step {w1['ms']['plain']!r} ms plain, {w1['ms']['mesh']!r} "
              f"ms on the mesh ({over:+.4f}); collectives a step {w1['collectives']}; {card}", flush=True)

        pair = report("pair", 2, *pair_run)
        backend = pair[0]["backend"]
        print(f"parallel two ranks: {backend} on cuda:{pair[0]['card']} and cuda:{pair[1]['card']}"
              + ("" if pair[0]["card"] != pair[1]["card"] else
                 " (one card shared by both ranks: correctness only, not a scaling number)"), flush=True)
        ref = {d: w1[d]["plain"] for d in ("fp32", "bf16")}
        for d in ("fp32", "bf16"):
            a, b = pair[0][d], pair[1][d]
            if a["losses"] != b["losses"] or any(not torch.equal(a["state"][k], b["state"][k]) for k in a["state"]):
                fail(f"parallel two ranks {d}: the ranks' losses or parameters differ after the step")
            if (a["mpbwd"], b["mpbwd"]) != (3, 3) or a["tal"] != b["tal"] or a["tal"] != [2, 2]:
                fail(f"parallel two ranks {d}: mpbwd launches {a['mpbwd']}, {b['mpbwd']} (3 a rank), tal "
                     f"{a['tal']}, {b['tal']} (2 + 2 a rank)")

        def gaps(got, against, grad):
            stats = [k for k in against["state"] if "running" in k]
            return (abs(got["losses"]["total"] - against["losses"]["total"]) / abs(against["losses"]["total"]),
                    grad(got["grads"], against["grads"]),
                    rel_gap({k: got["state"][k] for k in stats}, {k: against["state"][k] for k in stats}, 1.0))

        # fp32: the step as it runs (loss and statistics held; the gradients behind SPPF's max pools move
        # where a window's argmax moves), then with the pools' backward as an average pool's in every run,
        # where each gradient is held to the one-process step's own spread on the CPU (same draws).
        card32, box, box_cpu = ref["fp32"], w1["fp32"]["box"], w1["fp32"]["box_cpu"]
        front = lambda g: {k: v for k, v in g.items() if not behind_pools(k)}
        f32 = gaps(pair[0]["fp32"], card32, lambda g, r: grad_gap(front(g), front(r)))
        behind = grad_gap({k: v for k, v in pair[0]["fp32"]["grads"].items() if behind_pools(k)},
                          {k: v for k, v in card32["grads"].items() if behind_pools(k)})
        flips = pool_flips(torch.cat([rk["fp32"]["sppf_in"] for rk in pair]), card32["sppf_in"])
        dp_box, cpu_box = gaps(pair[0]["fp32_box"], box, grad_gap), gaps(box_cpu, box, grad_gap)
        l2 = (grad_l2(pair[0]["fp32_box"]["grads"], box["grads"]), grad_l2(box_cpu["grads"], box["grads"]))
        b16, rounding = gaps(pair[0]["bf16"], ref["bf16"], grad_gap_global), gaps(ref["bf16"], card32, grad_gap_global)
        print(f"parallel two ranks against one process on the global batch of {BATCH}, fp32 (loss relative, worst "
              f"gradient over its tensor's max|g|, worst running statistic over max(1, scale)): {f32} (the gradient "
              f"over every tensor in front of SPPF's max pools); behind them worst {behind!r}, where the pools' "
              f"argmax moved in {flips} of {card32['sppf_in'].numel()} windows a pool (furthest: "
              f"{grad_report(pair[0]['fp32']['grads'], card32['grads'], 2)}); {card}", flush=True)
        print(f"parallel two ranks, fp32 with the pools' backward as an average pool's: {dp_box}, relative L2 of all "
              f"gradients {l2[0]!r}; the one-process step on the CPU against the card (same draws): {cpu_box}, L2 "
              f"{l2[1]!r}; limits: loss 1e-5, statistics 1e-5, worst gradient and L2 the larger of 1e-4 and the "
              f"CPU's (furthest: {grad_report(pair[0]['fp32_box']['grads'], box['grads'], 2)})", flush=True)
        print(f"parallel two ranks bf16 against one process (gradients over the largest tensor's max|g|): {b16}; "
              f"limit: one process's bf16 against its fp32, {rounding}", flush=True)
        if not (f32[0] <= 1e-5 and f32[2] <= 1e-5 and dp_box[0] <= 1e-5 and dp_box[2] <= 1e-5
                and dp_box[1] <= max(1e-4, cpu_box[1]) and l2[0] <= max(1e-4, l2[1])):
            fail("parallel two ranks: the fp32 data-parallel step disagrees with the one-process step")
        if not all(x <= y for x, y in zip(b16, rounding)):
            fail("parallel two ranks: the bf16 data-parallel step is further from one process than bf16 is from fp32")
        ms = [statistics.median(rk["ms"]) for rk in pair]
        print(f"parallel two ranks bf16 step, {BATCH // 2} rows a rank: {ms[0]!r} / {ms[1]!r} ms (median of "
              f"{DP_PAIR_TIMED}, each rank's CUDA events, beside the one-rank job){'; not a scaling number: both ranks share one card' if pair[0]['card'] == pair[1]['card'] else ''}; "
              f"{card}", flush=True)
        for name, per in (("topk", PER_REQUEST), ("nms", PER_REQUEST_NMS)):
            a, b = pair[0]["predict"][name], pair[1]["predict"][name]
            launches = [{k: rk["predict"][name]["launches"][k] for k in per} for rk in pair]
            print(f"parallel Predictor(mesh=) bf16 folded {name}, global batch {BATCH}: launches a rank {launches}; "
                  f"rows equal to the rank's own predictor on them {a['same_as_local']}, {b['same_as_local']}",
                  flush=True)
            if launches != [per, per] or not (a["same_as_local"] and b["same_as_local"]):
                fail(f"parallel Predictor(mesh=) {name}: launches {launches}, expected {per} a rank")
            if not (torch.equal(a["dets"], b["dets"]) and torch.equal(a["num"], b["num"])):
                fail(f"parallel Predictor(mesh=) {name}: the ranks gathered different detections")

        # Sharded validation against the one-process run.
        sharded = [rk["val"]["stats"] for rk in pair]
        one_path = os.path.join(tmp, "dets1.json")
        kernels.reset_launches()
        one = validate_coco(loaded, images_dir=images_dir, ann_json=ann, imgsz=IMGSZ, batch_size=VAL_BATCH,
                            decode="topk", workers=8, save_detections=one_path)
        with open(one_path) as f, open(os.path.join(tmp, "dets2.json")) as g:
            matched, box_gap, score_gap = same_detections(json.load(f), json.load(g))
        gap = abs(sharded[0]["map_50_95"] - one["map_50_95"])
        vl = [rk["val"]["launches"]["topk"] for rk in pair]
        print(f"parallel sharded validation (fp32 top-k, host letterbox, {VAL_BATCH} images a process and batch): "
              f"{sharded[0]['n_images']} images, map_50_95 {sharded[0]['map_50_95']!r} against one process's "
              f"{one['map_50_95']!r} (gap {gap!r}, limit 1e-3); detections matched {matched}, largest box gap "
              f"{box_gap!r} px (limit 1e-3), score gap {score_gap!r}; top-k launches a rank {vl}; wall "
              f"{sharded[0]['wall_s']:.4f} s (the slowest shard) against {one['wall_s']:.4f} s in one process; "
              f"{card}", flush=True)
        if sharded[0] != sharded[1] or sharded[0]["n_images"] != VAL_IMAGES:
            fail("parallel sharded validation: the ranks' stats differ or miss images")
        if not (matched and box_gap <= 1e-3 and gap <= 1e-3) or vl != [2, 2]:
            fail("parallel sharded validation disagrees with the one-process run")


SPLIT_SEED = 16  # added to SEED: the images of the phase
# The meshes served, each by a job of n_data x n_second ranks of its own;
# the jobs run at once.
SPLIT_JOBS = (("sp", 1, 2), ("tp", 1, 2), ("sp", 1, 4))
# Timed requests a decode, after two untimed ones (the counted one, then the
# maps'): one, since a tp(1,2) request over gloo takes seconds and the run's
# time limit is near.
SPLIT_TIMED = 1
SPLIT_FP32_BATCH = 2
SPLIT_PROFILED = 2  # requests a rank's device profile holds
# Profiles a rank takes at most for its device time: four where each rank
# has a card of its own; one where the ranks share the card, where every
# profile lost records once the jobs ran at once (the other three cost a
# tp(1,2) rank about 40 s of requests).
SPLIT_PROFILE_TRIES = {"own": 4, "shared": 1}
SPLIT_DECODES = {"topk": {}, "nms": dict(decode="nms", conf_thresh=NMS_SETTINGS["infer"][0],
                                         iou_thresh=NMS_SETTINGS["infer"][1], class_wise_nms=True)}
# An op on a band or slice may differ from the whole op only where its sums
# run in cuDNN or cuBLAS, which pick their engine, and so the order of the
# sums, by shape: by at most SPLIT_LIB_ULPS bf16 ulps of its largest output
# (a sum rounded the other way, wherever the epilogue then takes it), in at
# most SPLIT_LIB_SHARE of its outputs.
SPLIT_LIB_ULPS = 1.0
SPLIT_LIB_SHARE = 1e-3
SPLIT_MIN_DECIDED = 200  # top-k rows the comparison with one process must decide


def maps_gap(got, ref, floor=None) -> dict:
    """Per head map (P3-P5, reg and cls): `got` against `ref` (max abs, rms)
    and, given `floor`, floor's rms against the same `ref` maps (the
    rounding gap that bounds it)."""
    out = {}
    for lvl in range(3):
        for j, name in enumerate(("reg", "cls")):
            a, r = got[lvl][j].float(), ref[lvl][j].float()
            g = {"max": max_err(a, r), "rms": float((a - r).pow(2).mean().sqrt()), "scale": float(r.abs().max())}
            if floor is not None:
                g["floor_rms"] = float((floor[lvl][j].float().to(r.device) - r).pow(2).mean().sqrt())
            out[f"P{lvl + 3} {name}"] = g
    return out


def topk_flat(maps, k: int):
    """(logits, flat indices) [B, k + 1] of the k + 1 largest class logits
    over every level's anchors and classes, largest first: the decode's
    top-k ranks the same logits."""
    import torch

    cls = torch.cat([c.float().reshape(c.shape[0], -1) for _, c in maps], 1)
    return torch.topk(cls, k + 1, dim=1)


def split_rank(argv) -> int:
    """A rank of the spatial and tensor parallel phase: python3 chip_smoke.py
    --split-rank R --job J --port P --root DIR. Runs yolov10s 640 bf16
    folded, both decodes, on the mesh SPLIT_JOBS[J] names, holds
    its gathered maps to the parent's threads running the same split, and
    saves what it saw under DIR."""
    import argparse

    p = argparse.ArgumentParser()
    for flag in ("--split-rank", "--job", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--root", required=True)
    args = p.parse_args(argv)
    rank = args.split_rank
    kind, n_data, n_second = SPLIT_JOBS[args.job]
    world = n_data * n_second
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    from leanyolo_tpu_torch import Predictor, YOLOv10, kernels
    from leanyolo_tpu_torch.kernels import _build
    from leanyolo_tpu_torch.models.yolov10.decode import decode_nms, decode_topk
    from leanyolo_tpu_torch.parallel.distributed import init_distributed
    from leanyolo_tpu_torch.parallel.mesh import make_sp_mesh, make_tp_mesh

    _build.ext()  # built by the parent: this loads it
    cards = "own" if torch.cuda.device_count() >= world else "shared"
    if cards == "own":
        init_distributed(f"127.0.0.1:{args.port}", world, rank, device="cuda")
    else:  # NCCL refuses two ranks on one card
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}", world_size=world,
                                rank=rank)
    inputs = torch.load(os.path.join(args.root, "split_inputs.pt"), weights_only=True)
    model = YOLOv10.create("yolov10s", class_names=[f"c{i}" for i in range(NC)])
    model.load_state_dict(inputs["state"])
    x = inputs["images"].cuda()
    say = lambda msg: print(f"{msg}; {dist.get_backend()}, rank {rank}/{world} on cuda:"
                            f"{torch.cuda.current_device()}", flush=True)
    common = dict(imgsz=IMGSZ, fuse=True, max_det=MAX_DET)
    out = {"backend": dist.get_backend(), "card": torch.cuda.current_device(), "meshes": {}}
    mesh = (make_sp_mesh if kind == "sp" else make_tp_mesh)(n_data, n_second, device="cuda")
    tag = f"{kind}({n_data},{n_second})"
    res = {}
    for d, kw in SPLIT_DECODES.items():
        pm = Predictor(model, dtype="bfloat16", mesh=mesh, **common, **kw)
        torch.cuda.synchronize()
        kernels.reset_launches()
        counter = (pm._space or pm._model_group).traffic
        counter.update((k, 0) for k in counter)
        dets, num = pm.run_batch(x)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        traffic = dict(counter)
        maps = pm.raw(x)
        strides = pm.model.cfg.strides
        if d == "topk":
            again = decode_topk(maps, num_classes=NC, strides=strides, max_det=MAX_DET).float()
            same_decode = torch.equal(again, dets)
        else:
            gd, gn = decode_nms(maps, num_classes=NC, strides=strides, conf_thresh=pm.conf_thresh,
                                iou_thresh=pm.iou_thresh, max_det=MAX_DET, class_wise=True,
                                rank_dtype=torch.float32)
            same_decode = torch.equal(gd, dets) and torch.equal(gn, num)
        emulated = inputs["emulated"][tag][d]
        walls = []
        for _ in range(SPLIT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pm.run_batch(x)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        events = split_profile(lambda: pm.run_batch(x), launches, SPLIT_PROFILE_TRIES[cards])
        res[d] = {"launches": launches, "traffic": traffic, "dets": dets.cpu(), "num": num.cpu(),
                  "same_decode": same_decode,
                  "same_emulated": all(torch.equal(a, b.to(a.device)) for lvl, el in zip(maps, emulated)
                                       for a, b in zip(lvl, el)),
                  "wall_ms": walls,
                  "device_ms": records_ms([events], SPLIT_PROFILED) if events else None,
                  "device_top": [(k[:48], c // SPLIT_PROFILED, t / SPLIT_PROFILED / 1e3)
                                 for k, c, t in sorted(events or [], key=lambda e: -e[2])[:6]]}
        if d == "topk":
            res["plan"] = (pm._space.plan.describe() if pm._space is not None else
                           {"split": len(pm.model.tp_plan["split"]), "whole": pm.model.tp_plan["whole"]})
        say(f"{tag} bf16 folded {d}, batch {BATCH}: launches {launches}, bytes received a request {traffic}, "
            f"wall ms {[round(w, 4) for w in walls]}, device ms {res[d]['device_ms']!r}")
        del pm, maps
        torch.cuda.empty_cache()
    pm32 = Predictor(model, dtype="float32", mesh=mesh, **common)
    res["fp32"] = [tuple(t.cpu() for t in lvl) for lvl in pm32.raw(x[:SPLIT_FP32_BATCH])]
    del pm32
    torch.cuda.empty_cache()
    out["meshes"][tag] = res
    torch.save(out, os.path.join(args.root, f"split_rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def split_profile(request, launches, tries: int):
    """This rank's device records [(kernel name, records, microseconds)] of
    SPLIT_PROFILED requests, or None where records were lost in every try.

    A profile is whole when each of the port's kernels kept SPLIT_PROFILED
    times the launches its counter gave one request, and every other
    kernel a multiple of SPLIT_PROFILED records. Every rank takes the same
    profiles (a rank alone taking one again would leave the others waiting
    in a collective): the ranks agree after each whether any lost records,
    and take it again together, `tries` in all at most."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from leanyolo_tpu_torch.utils.profiling import _family

    for attempt in range(tries):
        pad = PROFILE_PAD_S * 2 ** attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(SPLIT_PROFILED):
                request()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        ours = {}
        for k, c, _ in events:
            if _family(k) in PROFILE_FAMILIES:
                ours[PROFILE_FAMILIES[_family(k)]] = ours.get(PROFILE_FAMILIES[_family(k)], 0) + c
        whole = (all(ours.get(k, 0) == SPLIT_PROFILED * launches.get(k, 0) for k in set(ours) | set(launches))
                 and all(c % SPLIT_PROFILED == 0 for k, c, _ in events if _family(k) not in PROFILE_FAMILIES))
        lost = torch.tensor([0 if whole else 1], device="cuda")
        dist.all_reduce(lost, op=dist.ReduceOp.MAX)
        if not lost.item():
            return events
    return None


def split_decided(v, e):
    """Rows of a top-k [B, k] whose order the one-process path's own bf16
    rounding cannot change: `v` the k + 1 largest logits, largest first, `e`
    each one's gap to the fp32 predictor's logit at the same index; a row is
    decided where its gap to each neighbour exceeds the two rows' `e`."""
    import torch

    up = torch.cat([torch.full_like(v[:, :1], float("inf")), v[:, :-2] - v[:, 1:-1]], 1)
    e_up = torch.cat([torch.zeros_like(e[:, :1]), e[:, :-2]], 1)
    return (up > e_up + e[:, :-1]) & (v[:, :-1] - v[:, 1:] > e[:, :-1] + e[:, 1:])


class BandThreads:
    """n threads of this process standing in for a group's ranks
    (`Space(exchange=)`, `Channels(exchange=)`): their all-gathers meet at
    a barrier."""

    def __init__(self, n: int) -> None:
        import threading

        self.n, self.barrier, self.slots = n, threading.Barrier(n), [None] * n

    def exchange(self, pos: int):
        def gather(t):
            self.slots[pos] = t
            self.barrier.wait()
            out = list(self.slots)
            self.barrier.wait()
            return out
        return gather

    def run(self, fn):
        """[fn(pos) for every pos], each on its own thread."""
        import threading

        out, errors = [None] * self.n, []

        def one(pos):
            try:
                out[pos] = fn(pos)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(p,)) for p in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def split_copies(pm, kind: str, n: int):
    """(BandThreads, n copies of the one-process predictor `pm`): the
    ranks of a space group (`kind` "sp": `plan_bands(IMGSZ, n)`) or of a
    model group ("tp": each copy's model sliced by `shard_layers`) as
    threads of this process, exchanging through a barrier."""
    import copy

    from leanyolo_tpu_torch.parallel.spatial import Space, plan_bands
    from leanyolo_tpu_torch.parallel.tensor import Channels, shard_layers

    threads = BandThreads(n)
    copies = []
    for pos in range(n):
        pb = copy.copy(pm)
        if kind == "sp":
            pb._space = Space(plan_bands(IMGSZ, n), None, pos, threads.exchange(pos))
        else:
            pb.model = shard_layers(copy.deepcopy(pm.model), n, pos)
            pb._model_group = Channels(None, threads.exchange(pos))
        copies.append(pb)
    return threads, copies


def split_raw(pm, x, kind: str, n: int) -> list:
    """The head maps of x from `split_copies(pm, kind, n)`, gathered as a
    mesh's predictor gathers them (every thread's are the same; the first's)."""
    threads, copies = split_copies(pm, kind, n)
    return threads.run(lambda pos: copies[pos].raw(x))[0]


# The ops the split check holds one at a time: each class's own forward (or
# method) as the folded serving path calls it, the SPPF pool and the stem.
SPLIT_OPS = (("Conv", "forward"), ("MatmulConv", "forward"), ("ConvBNAct", "forward"),
             ("ConvBNAct", "forward_upcat"), ("FusedRepVGGDW", "forward"), ("S2DConvBNAct", "forward"),
             ("Attention", "forward"))


def split_ops(pm, x, kind: str, n: int) -> list:
    """The one-process predictor `pm`'s model on x whole, then split as
    `split_copies` splits it, op by op: each op the outermost at its call
    (`SPLIT_OPS`, the SPPF pools, the fused stem) is given, on every rank,
    the very rows of its input that the whole run gave it (its band, whose
    halo rows then come from the op's own exchange, or the whole input of
    a sliced layer), and its output, joined over the bands or gathered over
    the channel slices, is held to the whole run's. An op whose output then
    differs computes otherwise at the split's shape, whatever the ops before
    it did. Returns, for every op called in the whole run's order, {"op",
    "shape" (the whole input's), "max" (abs diff), "share" (of outputs that
    differ), "ulps" (the largest diff in bf16 ulps of the largest |output|),
    "scale" (that largest |output|), "lib": whether the op's sums run in cuDNN or cuBLAS (a
    plain Conv's conv2d, Attention's products) rather than in the port's
    kernels or in exact torch ops}."""
    import threading

    import torch
    from leanyolo_tpu_torch.models.yolov10 import layers as L
    from leanyolo_tpu_torch.models.yolov10.model import Backbone
    from leanyolo_tpu_torch.parallel.spatial import plan_bands

    plan = plan_bands(IMGSZ, n) if kind == "sp" else None
    threads, copies = split_copies(pm, kind, n)
    names = {id(m): k for p in [pm] + copies for k, m in p.model.named_modules()}
    tl = threading.local()
    whole_in, whole_out, lib, order = {}, {}, {}, []

    def library(m) -> bool:
        if isinstance(m, L.Attention):
            return True
        if isinstance(m, (L.FusedRepVGGDW, L.S2DConvBNAct)):
            return False
        conv = m.conv if isinstance(m, L.ConvBNAct) else m
        return isinstance(conv, L.Conv) and not isinstance(conv, L.MatmulConv)

    def rows_of(a, w, pos):
        if plan is None or not plan.split(IMGSZ // w.shape[2]):
            lo, hi = 0, w.shape[2]
        else:
            lo, hi = plan.band(IMGSZ // w.shape[2], pos)
        if a.shape[2] != hi - lo or a.shape[:2] != w.shape[:2]:
            raise AssertionError(f"split op input {tuple(a.shape)} is not rows {lo}-{hi} of {tuple(w.shape)}")
        return torch.empty_like(a).copy_(w.narrow(2, lo, hi - lo))  # the split run's own memory format

    def wrap(fn, label, swap=True):
        def call(*args, **kw):
            mode = getattr(tl, "mode", None)
            if mode is None:
                return fn(*args, **kw)
            name, is_lib = label(args)
            i = tl.calls[name] = tl.calls.get(name, -1) + 1
            key = (name, i)
            if mode == "whole":
                whole_in[key], lib[key] = args, is_lib
                order.append(key)
            elif swap and tl.depth == 0:
                args = tuple(rows_of(a, w, tl.pos) if torch.is_tensor(a) and a.ndim == 4 else a
                             for a, w in zip(args, whole_in[key]))
            tl.depth += 1
            try:
                y = fn(*args, **kw)
            finally:
                tl.depth -= 1
            (whole_out if mode == "whole" else tl.out)[key] = y
            return y
        return call

    def start(mode, pos=0):
        tl.mode, tl.pos, tl.depth, tl.calls, tl.out = mode, pos, 0, {}, {}

    def split(pos):
        start("split", pos)
        copies[pos].raw(x)
        return tl.out

    saved = [(getattr(L, c), m, getattr(L, c).__dict__[m]) for c, m in SPLIT_OPS if m in getattr(L, c).__dict__]
    saved_pool, saved_stem = L.maxpool2d_same, Backbone.__dict__["stem"]
    for cls, meth, fn in saved:
        setattr(cls, meth, wrap(fn, lambda a, cls=cls, meth=meth: (f"{names[id(a[0])]} {cls.__name__}.{meth}",
                                                                    library(a[0]))))
    L.maxpool2d_same = wrap(saved_pool, lambda a: ("SPPF pool", False))
    Backbone.stem = wrap(saved_stem, lambda a: ("stem", False), swap=False)
    try:
        start("whole")
        pm.raw(x)
        tl.mode = None
        outs = threads.run(split)
    finally:
        for cls, meth, fn in saved:
            setattr(cls, meth, fn)
        L.maxpool2d_same, Backbone.stem = saved_pool, saved_stem
    report = []
    for key in order:
        want, got = whole_out[key], [o[key] for o in outs]
        if plan is not None and plan.split(IMGSZ // want.shape[2]):
            joined = torch.cat(got, 2)
        else:
            joined = got[0]
            if not all(torch.equal(g, joined) for g in got):
                raise AssertionError(f"split op {key}: the ranks' whole outputs differ")
        d = (joined.float() - want.float()).abs()
        scale = float(want.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7) if scale > 0 else 2.0 ** -133  # bf16: 8 significant bits
        report.append({"op": f"{key[0]}#{key[1]}" if key[1] else key[0],
                       "shape": next(tuple(a.shape) for a in whole_in[key] if torch.is_tensor(a)),
                       "max": float(d.max()), "share": float((d > 0).float().mean()), "ulps": float(d.max()) / ulp,
                       "scale": scale, "lib": lib[key]})
    return report


def one_topk(maps, floor) -> dict:
    """The one-process top-k (largest class logits, `topk_flat`) of `maps`
    and each logit's gap to `floor`'s at the same index (the path's own
    rounding there)."""
    import torch

    v, idx = topk_flat(maps, MAX_DET)
    f = torch.cat([c.float().reshape(c.shape[0], -1) for _, c in floor], 1)
    return {"v": v, "idx": idx, "e": (v - f.gather(1, idx)).abs()}


def phase_split(model, seed: int, card: str) -> None:
    """Spatial and tensor parallelism on the card (item 15 of the module doc)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from leanyolo_tpu_torch import Predictor
    from leanyolo_tpu_torch.parallel.dryrun import check_ranks, spawn_ranks
    from leanyolo_tpu_torch.parallel.spatial import plan_bands

    for n in (2, 4):
        print(f"split band plan: {plan_bands(IMGSZ, n).describe()}", flush=True)
    rng = np.random.RandomState(seed + SPLIT_SEED)
    images = torch.from_numpy(rng.randint(0, 256, (BATCH, IMGSZ, IMGSZ, 3)).astype(np.uint8))
    x = images.cuda()
    host = lambda maps: [tuple(t.cpu() for t in lvl) for lvl in maps]  # noqa: E731
    common = dict(imgsz=IMGSZ, fuse=True, max_det=MAX_DET)
    # The one-process references on the card (and fp32 on the CPU at batch 2).
    one = {d: Predictor(model, dtype="bfloat16", **common, **kw) for d, kw in SPLIT_DECODES.items()}
    ref = {d: {"maps": host(pm.raw(x)), "dets": [t.cpu() for t in pm.run_batch(x)]} for d, pm in one.items()}
    ref32 = {d: host(Predictor(model, dtype="float32", **common, **kw).raw(x)) for d, kw in SPLIT_DECODES.items()}
    ref_small = host(Predictor(model, dtype="float32", **common).raw(x[:SPLIT_FP32_BATCH]))
    cpu_small = Predictor(model, dtype="float32", device="cpu", **common).raw(images[:SPLIT_FP32_BATCH])
    top, top32 = one_topk(ref["topk"]["maps"], ref32["topk"]), one_topk(ref_small, cpu_small)
    decided, decided32 = split_decided(top["v"], top["e"]), split_decided(top32["v"], top32["e"])
    # The same process, the ranks as its threads: each op on its band or
    # slice against the whole op, then the maps the ranks must return.
    emulated, exact = {}, {}
    for kind, n_data, n_second in SPLIT_JOBS:
        tag = f"{kind}({n_data},{n_second})"
        t0 = time.perf_counter()
        rep = split_ops(one["topk"], x, kind, n_second)
        differ = [r for r in rep if r["max"] > 0]
        print(f"split {tag} op by op in one process, bf16 batch {BATCH}, each op on the whole run's input: "
              f"{len(rep)} ops, {len(rep) - len(differ)} bit-equal; the others (op, whole input shape, max, "
              f"share of outputs, ulps, scale, cuDNN/cuBLAS): "
              f"{[(r['op'], r['shape'], r['max'], r['share'], r['ulps'], r['scale'], r['lib']) for r in differ]}",
              flush=True)
        for r in differ:
            if not r["lib"]:
                fail(f"split {tag}: {r['op']} runs on the port's kernels or exact ops and differs from the "
                     f"whole op on the same input rows by {r['max']!r} (a halo, crop or slice is wrong)")
            if r["ulps"] > SPLIT_LIB_ULPS or r["share"] > SPLIT_LIB_SHARE:
                fail(f"split {tag}: {r['op']} differs from the whole op on the same input rows by {r['ulps']!r} "
                     f"bf16 ulps in {r['share']!r} of its outputs (at most {SPLIT_LIB_ULPS} in "
                     f"{SPLIT_LIB_SHARE}, what another cuDNN engine's order of sums gives)")
        exact[tag] = not differ  # then the split path is one process's, op for op
        emulated[tag] = {d: host(split_raw(pm, x, kind, n_second)) for d, pm in one.items()}
        print(f"split {tag} op check and threads' maps in {time.perf_counter() - t0:.1f} s", flush=True)
        del rep
        torch.cuda.empty_cache()
    del one, x
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "split_inputs.pt")
        torch.save({"state": model.state_dict(), "images": images, "emulated": emulated}, inputs)

        def job(i: int, port: int):
            """The ranks of SPLIT_JOBS[i] in a root of their own: (results, wall s, root)."""
            root = os.path.join(tmp, f"job{i}")
            os.makedirs(root)
            os.link(inputs, os.path.join(root, "split_inputs.pt"))
            _, n_data, n_second = SPLIT_JOBS[i]
            t0 = time.perf_counter()
            results = spawn_ranks(lambda r: [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--split-rank",
                                             str(r), "--job", str(i), "--port", str(port), "--root", root],
                                  n_data * n_second, timeout=600)
            return results, time.perf_counter() - t0, root

        # Every job at once (the run's time limit): their walls and device
        # times are those of one card shared by all ranks.
        with ThreadPoolExecutor(len(SPLIT_JOBS)) as pool:
            running = [pool.submit(job, i, port) for i, port in enumerate(free_ports(len(SPLIT_JOBS)))]
            done = [f.result() for f in running]
        for (kind, n_data, n_second), (results, wall, root) in zip(SPLIT_JOBS, done):
            world, tag = n_data * n_second, f"{kind}({n_data},{n_second})"
            for r, (_, out, _) in enumerate(results):
                for line in out.splitlines():
                    print(f"  [split rank {r}/{world}] {line}", flush=True)
            try:
                check_ranks(results, f"split {tag}")
            except RuntimeError as e:
                fail(str(e))
            ranks = [torch.load(os.path.join(root, f"split_rank{r}.pt"), weights_only=True) for r in range(world)]
            shared = ranks[0]["card"] == ranks[-1]["card"]
            shared_note = ", one card shared by all jobs: correctness only, no scaling number" if shared else ""
            print(f"split {tag}: {world} ranks ({ranks[0]['backend']}{shared_note}) done in {wall:.1f} s, start-up "
                  f"included", flush=True)
            rs = [rk["meshes"][tag] for rk in ranks]
            print(f"split {tag} plan a rank: {rs[0]['plan']}", flush=True)
            for d, per in (("topk", PER_REQUEST), ("nms", PER_REQUEST_NMS)):
                launches = [{k: r[d]["launches"].get(k, 0) for k in per} for r in rs]
                routes = [{k: r[d]["launches"].get(k, 0) for k in NEW_ROUTES} for r in rs]
                if launches != [per] * world:
                    fail(f"split {tag} {d}: launches a rank {launches}, expected {per} on every rank")
                if not all(r[d]["same_decode"] for r in rs):
                    fail(f"split {tag} {d}: a rank's detections are not the decode of its gathered maps")
                if not all(torch.equal(r[d]["dets"], rs[0][d]["dets"]) and torch.equal(r[d]["num"], rs[0][d]["num"])
                           for r in rs):
                    fail(f"split {tag} {d}: the ranks returned different detections")
                if not all(r[d]["same_emulated"] for r in rs):
                    fail(f"split {tag} {d}: a rank's gathered head maps differ from this process's threads "
                         f"running the same split (the exchange between processes is wrong)")
                maps = emulated[tag][d]  # every rank's, bit for bit
                worst = {}
                for name, g in maps_gap(maps, ref[d]["maps"], ref32[d]).items():
                    worst[name] = (g["rms"], g["floor_rms"], g["max"], g["scale"])
                    if not g["rms"] <= g["floor_rms"]:
                        fail(f"split {tag} {d} head {name}: rms {g['rms']!r} against one process, beyond "
                             f"bf16's own rms {g['floor_rms']!r} (one process bf16 vs fp32)")
                    if exact[tag] and g["max"] != 0:
                        fail(f"split {tag} {d} head {name}: every op on its band or slice was the whole op's, "
                             f"yet the map differs from one process's by {g['max']!r}")
                dets, num = rs[0][d]["dets"], rs[0][d]["num"]
                rdets, rnum = ref[d]["dets"]
                same_rows = float((dets == rdets).all(dim=-1).float().mean())
                if d == "topk":
                    # Reported, not held: in bf16 a cuDNN sum rounded the other
                    # way moves these random weights' logits by up to whole
                    # units, past any gap the one-process path gives (the
                    # threads' maps above stand for the split path here).
                    same = topk_flat(maps, MAX_DET)[1][:, :-1] == top["idx"][:, :-1]
                    print(f"split {tag} bf16 top-k against one process: the same anchor and class in "
                          f"{float(same.float().mean())!r} of the rows; {int(decided.sum())} of "
                          f"{decided.numel()} rows decided by the one-process bf16-vs-fp32 gaps, "
                          f"{int((decided & same).sum())} of them the same; detection rows bit-equal "
                          f"{same_rows!r}", flush=True)
                else:
                    print(f"split {tag} NMS against one process: counts equal in {int((num == rnum).sum())} of "
                          f"{BATCH} images, rows bit-equal {same_rows!r}", flush=True)
                wall = [statistics.median(r[d]["wall_ms"]) for r in rs]
                dev = [r[d]["device_ms"] for r in rs]
                print(f"split {tag} bf16 folded {d} batch {BATCH}: launches a rank {launches[0]} (routes "
                      f"{routes}); bytes received a request a rank {[r[d]['traffic'] for r in rs]}; head maps "
                      f"(rms, bf16 floor rms, max, scale) {worst}; wall ms a request (median of {SPLIT_TIMED}) "
                      f"{wall}, device ms a request {dev} (None: records lost in every profile, "
                      f"{SPLIT_PROFILE_TRIES['shared' if shared else 'own']} at most), rank 0's "
                      f"largest (kernel, launches, ms) a request {rs[0][d]['device_top']}; {card}", flush=True)
            maps32 = rs[0]["fp32"]
            if not all(torch.equal(a, b) for r in rs for lvl, l0 in zip(r["fp32"], maps32) for a, b in zip(lvl, l0)):
                fail(f"split {tag} fp32: the ranks returned different head maps")
            for name, g in maps_gap(maps32, ref_small).items():
                if g["max"] != 0:
                    fail(f"split {tag} fp32 head {name}: max {g['max']!r} of scale {g['scale']!r} against the "
                         f"one-process fp32 predictor (bit-equal wanted)")
            same = topk_flat(maps32, MAX_DET)[1][:, :-1] == top32["idx"][:, :-1]
            n_dec, n_same = int(decided32.sum()), int((decided32 & same).sum())
            print(f"split {tag} fp32 batch {SPLIT_FP32_BATCH}: head maps bit-equal to one process; top-k "
                  f"{n_dec} of {decided32.numel()} rows decided (each logit's gap to its neighbours beyond the "
                  f"two rows' one-process card-vs-CPU gaps), {n_same} of them the same anchor and class",
                  flush=True)
            if n_dec < SPLIT_MIN_DECIDED or n_same != n_dec:
                fail(f"split {tag} fp32 top-k: {n_dec} decided rows (at least {SPLIT_MIN_DECIDED}), "
                     f"{n_dec - n_same} of them differ from the one-process predictor's")


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), for the special-function floor."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def set_bound(r: dict, nbytes: float, nops: float, kind: str) -> None:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[kind] * 1e3
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    # fp32 comparisons hold plain fp32 math: no TF32 in cuDNN or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    from leanyolo_tpu_torch.kernels import _build
    from leanyolo_tpu_torch.models.yolov10.fold import fold_model

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.ext()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    records = {
        name: {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": 0}
        for name, src, rep in (
            ("stem", "leanyolo_tpu_torch/kernels/csrc/stem.cu", "experiments/stem_pallas.py:293"),
            ("dw7x7", "leanyolo_tpu_torch/kernels/csrc/dw7x7.cu", "experiments/exp_dw_pallas.py:79"),
            ("topk", "leanyolo_tpu_torch/kernels/csrc/topk.cu", "leanyolo_tpu/ops/topk.py:69"),
            ("mpbwd", "leanyolo_tpu_torch/kernels/csrc/mpbwd.cu", "experiments/exp_sppf_bwd.py:86"),
            ("s2dconv", "leanyolo_tpu_torch/kernels/csrc/s2dconv.cu", "experiments/exp_pallas_k2.py:42"),
            ("bmm", "leanyolo_tpu_torch/kernels/csrc/matmul.cu", "experiments/exp_pallas_mm.py:47"),
            ("argmax", "leanyolo_tpu_torch/kernels/csrc/argmax.cu", "leanyolo_tpu/ops/topk.py:90"),
            ("nms", "leanyolo_tpu_torch/kernels/csrc/nms.cu", "leanyolo_tpu/ops/boxes.py:163"),
            ("topk_decode", "leanyolo_tpu_torch/kernels/csrc/topk.cu", "leanyolo_tpu/models/yolov10/decode.py:102"),
            ("dfl_boxes", "leanyolo_tpu_torch/kernels/csrc/decode.cu", "leanyolo_tpu/models/yolov10/decode.py:191"),
            ("bn_moments", "leanyolo_tpu_torch/kernels/csrc/bnstats.cu", "leanyolo_tpu/models/yolov10/layers.py:202"),
            ("bn_moments_bwd", "leanyolo_tpu_torch/kernels/csrc/bnstats.cu",
             "leanyolo_tpu/models/yolov10/layers.py:202"),
            ("tal_candidates", "leanyolo_tpu_torch/kernels/csrc/tal.cu", "leanyolo_tpu/ops/tal.py:47"),
            ("tal_targets", "leanyolo_tpu_torch/kernels/csrc/tal.cu", "leanyolo_tpu/ops/tal.py:99"),
        )
    }
    # Kernels rebuilt for Hopper after their first port, by the port's slice
    # that rebuilt them.
    for name, part in (("dw7x7", "slice 4"), ("bmm", "slice 4"), ("stem", "slice 5"), ("s2dconv", "slice 5"),
                       ("topk", "slice 6"), ("mpbwd", "slice 6"), ("nms", "slice 14"),
                       ("dfl_boxes", "slice 21")):
        records[name]["redesigned"] = part
    # The fused second top-k: the level gather (K2, decode.py:102) and the box
    # decode (K3, decode.py:191, ops/anchors.py:73) folded into the top-k
    # kernel's key builder and epilogue.
    records["topk_decode"].update(redesigned="slice 21", also_replaces=["leanyolo_tpu/models/yolov10/decode.py:191",
                                                                        "leanyolo_tpu/ops/anchors.py:73"])
    t_run = time.perf_counter()

    def done(phase: str) -> None:
        print(f"phase {phase} done at {time.perf_counter() - t_run:.1f} s after the build", flush=True)

    model = make_model(SEED)
    folded = fold_model(model, dtype=torch.bfloat16).cuda().to(memory_format=torch.channels_last)  # as Predictor
    calls = phase_kernels(folded, SEED, records)
    with check_time(DECODE_CHECK_S, "the decode kernels against their plain versions"):
        phase_decode_kernels(SEED, records)
    with check_time(BN_CHECK_S, "K8 against its plain versions"):
        phase_bn_kernels(SEED, records)
    with check_time(TAL_CHECK_S, "K6 and K7 against the plain version"):
        phase_tal_kernels(SEED, records)
    done("kernels")
    pred, x32 = phase_main(model, SEED, records)
    done("serving")
    serving_profile = phase_times(folded, SEED, records, pred, x32, calls)
    done("times")
    del pred, x32, folded, calls
    torch.cuda.empty_cache()
    phase_nms_kernels(SEED, records)
    pred, x32 = phase_nms(model, SEED, records)
    phase_nms_times(SEED, records, pred, x32)
    phase_predict_images(model, SEED)
    done("nms")
    phase_weights(model, SEED, card)
    done("weights")
    phase_validation(model, SEED, card)
    done("validation")
    del pred, x32
    torch.cuda.empty_cache()
    phase_variants(SEED, records)
    done("variants")
    with torch.enable_grad():
        tal_calls = phase_train(SEED, records)
    phase_train_times(SEED, records, tal_calls)
    del tal_calls
    done("train")
    with torch.enable_grad():
        phase_wide_train(SEED)
    done(f"train at {WIDE_IMGSZ} px")
    phase_profile_step(card, serving_profile)
    done("profile_step")
    with tempfile.TemporaryDirectory() as tmp:
        phase_bench(card, serving_profile["run_batch_ms"], tmp)
        done("bench CLIs")
        with torch.enable_grad():
            sets = phase_train_folder(SEED, records, card, tmp)
        # From here to the end of phase_tools the card is shared: the
        # shortened QT-001 trains beside the CLIs and checks that time nothing.
        qt = start_qt001(tmp)
        phase_train_clis(SEED, card, tmp, sets)
        done("train from a folder")
        phase_tools(SEED, card, tmp, qt)
    done("tools")
    # Last: it exports programs and starts a CLI, and no later phase needs the profiler.
    phase_nms_bf16(SEED, records)
    phase_dispatch(model, card)
    phase_export(model, SEED, card)
    phase_infer_cli(model, SEED, card)
    done("drawing and export")
    phase_parallel(model, SEED, card)
    done("parallel")
    phase_split(model, SEED, card)
    done("spatial and tensor parallel")

    print(f"the decode kernels' (the fused second top-k, K3, K4's flags) checks and times took "
          f"{sum(DECODE_CHECK_S.values()):.1f} s: "
          f"{ {k: round(v, 1) for k, v in DECODE_CHECK_S.items()} }", flush=True)
    print(f"the batch moments' (K8) checks and times took {sum(BN_CHECK_S.values()):.1f} s: "
          f"{ {k: round(v, 1) for k, v in BN_CHECK_S.items()} }", flush=True)
    print(f"the assignment's (K6, K7) checks and times took {sum(TAL_CHECK_S.values()):.1f} s: "
          f"{ {k: round(v, 1) for k, v in TAL_CHECK_S.items()} }; the run took {time.perf_counter() - t_start:.1f} s "
          f"in all, the build included", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    sys.exit(split_rank(argv) if "--split-rank" in argv else dp_rank(argv) if "--rank" in argv else main())
