"""COCO bbox mAP evaluation in pure numpy (pycocotools' protocol).

Counterpart of the JAX package's `leanyolo_tpu/utils/coco_eval.py`, a copy
kept so the port never imports the JAX package; it gives the same numbers
on the same inputs. The COCOeval bbox protocol: 10 IoU thresholds
0.50:0.05:0.95, 101-point interpolated precision, greedy score-ordered
matching with crowd ("ignore") handling, area ranges, and maxDets=100;
`evaluate()` returns `COCOeval.summarize()` stats[0..5] under the names
map_50_95, map_50, map_75, map_small, map_medium, map_large.

Columnar and batched, so scoring can run incrementally during validation
while the device runs the next batch:

- `add_detections_arrays` ingests columnar numpy (no per-detection dicts);
- `score_images(ids)` finalizes those images' per-detection TP/ignore flags
  with a batched greedy matcher (vectorized over (image, category) pairs x
  4 area ranges x 10 IoU thresholds; the only Python loop is over
  detection rank, which greedy matching makes sequential);
- `evaluate()` scores whatever remains and aggregates with a global
  lexsort whose tie keys (image rank, per-image det rank) make incremental
  and one-shot scoring give identical numbers.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

MAX_DETS = 100  # detections scored per image, COCO's maxDets
IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
_AREA_ORDER = ("all", "small", "medium", "large")
_AREA_LO = np.array([AREA_RNGS[a][0] for a in _AREA_ORDER])
_AREA_HI = np.array([AREA_RNGS[a][1] for a in _AREA_ORDER])
_NA = len(_AREA_ORDER)
_NT = len(IOU_THRS)
# Matcher acceptance thresholds (pycocotools: min(t, 1-1e-10)).
_THR_EFF = np.minimum(IOU_THRS, 1 - 1e-10)


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix [D, G] for xywh boxes; crowd GTs use intersection/det-area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None])
    iy1 = np.maximum(dy1[:, None], gy1[None])
    ix2 = np.minimum(dx2[:, None], gx2[None])
    iy2 = np.minimum(dy2[:, None], gy2[None])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


def _iou_xywh_pairs(d_boxes: np.ndarray, g_boxes: np.ndarray, g_crowd: np.ndarray) -> np.ndarray:
    """Batched IoU [P, D, G] for padded per-pair boxes (same crowd rule)."""
    dx1, dy1 = d_boxes[..., 0], d_boxes[..., 1]
    dx2, dy2 = dx1 + d_boxes[..., 2], dy1 + d_boxes[..., 3]
    gx1, gy1 = g_boxes[..., 0], g_boxes[..., 1]
    gx2, gy2 = gx1 + g_boxes[..., 2], gy1 + g_boxes[..., 3]
    ix1 = np.maximum(dx1[:, :, None], gx1[:, None, :])
    iy1 = np.maximum(dy1[:, :, None], gy1[:, None, :])
    ix2 = np.minimum(dx2[:, :, None], gx2[:, None, :])
    iy2 = np.minimum(dy2[:, :, None], gy2[:, None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = (d_boxes[..., 2] * d_boxes[..., 3])[:, :, None]
    g_area = (g_boxes[..., 2] * g_boxes[..., 3])[:, None, :]
    union = np.where(g_crowd[:, None, :], d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-12)


def _match_pairs(d_boxes, d_scores, d_count, g_boxes, g_crowd, g_area, g_count):
    """Batched greedy matching over padded (image, category) pairs.

    Inputs (P pairs, D = max dets per pair AFTER score sort + maxDets
    truncation, G = max gts per pair):
        d_boxes [P,D,4] xywh, d_scores [P,D] (desc per pair), d_count [P],
        g_boxes [P,G,4], g_crowd [P,G] bool, g_area [P,G] (annotation area),
        g_count [P].

    Returns (tp [P,A,T,D], ig [P,A,T,D], num_gt [P,A]) where A indexes
    `_AREA_ORDER` and T the IoU thresholds.

    Exact semantics of pycocotools' evaluateImg: detections scan GTs
    ignore-sorted; an already-claimed non-crowd GT is skipped; once a non-ignored candidate is held, ignored
    GTs are not considered; equal IoU resolves to the LATER GT (the scan
    updates on `>=`). The physical ignore-sort is unnecessary here: phase 1
    takes the last argmax over eligible non-ignored GTs, phase 2 (only if
    phase 1 found nothing above threshold) over eligible ignored ones —
    a stable sort by the ignore flag preserves relative order inside each
    class, so per-class last-argmax in original order is identical.
    """
    P, D, _ = d_boxes.shape
    G = g_boxes.shape[1]
    S = _NA * _NT
    valid_d = np.arange(D)[None, :] < d_count[:, None]  # [P,D]
    valid_g = np.arange(G)[None, :] < g_count[:, None]  # [P,G]

    # Area-gated ignore per area range (crowd is always ignored).
    g_ignore = (
        g_crowd[:, None, :]
        | (g_area[:, None, :] < _AREA_LO[None, :, None])
        | (g_area[:, None, :] > _AREA_HI[None, :, None])
    ) & valid_g[:, None, :]  # [P,A,G]
    real_a = valid_g[:, None, :] & ~g_ignore  # [P,A,G]
    num_gt = real_a.sum(-1)  # [P,A]

    # Scenario axis: A areas x T thresholds flattened to S.
    real_s = np.repeat(real_a, _NT, axis=1)  # [P,S,G]
    ig_s = np.repeat(g_ignore, _NT, axis=1)
    thr_s = np.tile(_THR_EFF, _NA)[None, :]  # [1,S]
    crowd_b = g_crowd[:, None, :]  # [P,1,G]

    ious = _iou_xywh_pairs(d_boxes, g_boxes, g_crowd)  # [P,D,G]

    matched = np.zeros((P, S, G), bool)
    dt_match = np.zeros((P, S, D), bool)
    dt_ig = np.zeros((P, S, D), bool)
    gidx = np.arange(G)
    for di in range(D):
        iou_d = ious[:, di][:, None, :]  # [P,1,G]
        # Phase 1: non-ignored GTs, eligible unless already claimed.
        elig = real_s & ~matched
        val = np.where(elig, iou_d, -1.0)
        best_r = val.max(-1)  # [P,S]
        idx_r = (G - 1) - np.argmax(val[..., ::-1], -1)
        ok_r = best_r >= thr_s
        # Phase 2: ignored GTs (crowd stays eligible after a claim).
        elig = ig_s & (~matched | crowd_b)
        val = np.where(elig, iou_d, -1.0)
        best_i = val.max(-1)
        idx_i = (G - 1) - np.argmax(val[..., ::-1], -1)
        ok_i = ~ok_r & (best_i >= thr_s)
        ok = (ok_r | ok_i) & valid_d[:, di][:, None]
        chosen = np.where(ok_r, idx_r, idx_i)  # [P,S]
        matched |= (gidx[None, None, :] == chosen[..., None]) & ok[..., None]
        dt_match[:, :, di] = ok
        dt_ig[:, :, di] = ok & ok_i & valid_d[:, di][:, None]

    # Unmatched dets outside the area range are ignored.
    d_out = (
        ((d_boxes[..., 2] * d_boxes[..., 3])[:, None, :] < _AREA_LO[None, :, None])
        | ((d_boxes[..., 2] * d_boxes[..., 3])[:, None, :] > _AREA_HI[None, :, None])
    )  # [P,A,D]
    dt_match = dt_match.reshape(P, _NA, _NT, D)
    dt_ig = dt_ig.reshape(P, _NA, _NT, D)
    dt_ig = dt_ig | (~dt_match & d_out[:, :, None, :])
    tp = dt_match & ~dt_ig
    return tp, dt_ig, num_gt


class CocoEvaluator:
    """Accumulates detections against COCO-format ground truth.

    Args:
        gt: a loaded COCO annotation dict (keys: images, annotations,
            categories) or a path to the JSON.

    Detections may be fed as dicts (`add_detections`) or columnar arrays
    (`add_detections_arrays`). `score_images(ids)` may be called any time
    after ALL detections for those images have been added — validation
    calls it per batch so the matching cost overlaps the device step; a
    later add for an already-scored image transparently falls back to
    rescoring everything at `evaluate()`.
    """

    def __init__(self, gt) -> None:
        if isinstance(gt, str):
            with open(gt, "r", encoding="utf-8") as f:
                gt = json.load(f)
        self.img_ids = sorted(im["id"] for im in gt.get("images", []))
        self._img_ids_arr = np.asarray(self.img_ids, np.int64)
        self.cat_ids = sorted(c["id"] for c in gt.get("categories", []))
        self._cat_rank = {c: k for k, c in enumerate(self.cat_ids)}

        tmp: Dict[tuple, list] = defaultdict(list)
        for a in gt.get("annotations", []):
            area = a.get("area", a["bbox"][2] * a["bbox"][3])
            tmp[(a["image_id"], a["category_id"])].append(
                (a["bbox"][0], a["bbox"][1], a["bbox"][2], a["bbox"][3], int(a.get("iscrowd", 0)), float(area))
            )
        # (img, cat) -> (boxes [G,4] f64, crowd [G] bool, area [G] f64)
        self._gt: Dict[tuple, tuple] = {}
        self._gt_cats_by_img: Dict[int, list] = defaultdict(list)
        for key, rows in tmp.items():
            arr = np.asarray(rows, np.float64)
            self._gt[key] = (arr[:, :4], arr[:, 4].astype(bool), arr[:, 5])
            self._gt_cats_by_img[key[0]].append(key[1])

        self._dt_cols: Dict[tuple, list] = defaultdict(list)  # key -> [(boxes, scores)]
        self._dt_cats_by_img: Dict[int, set] = defaultdict(set)
        self._reset_scoring()

    # ------------------------------------------------------------------ feed

    def _reset_scoring(self) -> None:
        self._scored: set = set()
        # cat_id -> list of chunks; chunk = ("full", scores, img_rank,
        # det_rank, tp [A,T,n], ig [A,T,n]) or ("simple", scores, img_rank,
        # det_rank, d_out [A,n]) — simple = no GT of this cat in the image,
        # where flags are T-independent (never matched; ignored iff the det
        # area falls outside the range), stored compactly.
        self._acc: Dict[int, list] = defaultdict(list)
        self._num_gt = np.zeros((len(self.cat_ids), _NA), np.int64)

    def add_detections(self, results: Sequence[dict]) -> None:
        """results: COCO result dicts {image_id, category_id, bbox xywh, score}."""
        results = list(results)
        if not results:
            return
        n = len(results)
        img = np.fromiter((r["image_id"] for r in results), np.int64, n)
        cat = np.fromiter((r["category_id"] for r in results), np.int64, n)
        bbox = np.asarray([r["bbox"] for r in results], np.float64).reshape(n, 4)
        score = np.fromiter((r["score"] for r in results), np.float64, n)
        self.add_detections_arrays(img, cat, bbox, score)

    def add_detections_arrays(
        self,
        image_ids: np.ndarray,
        category_ids: np.ndarray,
        boxes_xywh: np.ndarray,
        scores: np.ndarray,
    ) -> None:
        """Columnar feed: image_ids [N], category_ids [N], boxes_xywh [N,4],
        scores [N]. No per-detection Python objects are created."""
        image_ids = np.asarray(image_ids, np.int64)
        n = len(image_ids)
        if n == 0:
            return
        category_ids = np.asarray(category_ids, np.int64)
        boxes = np.asarray(boxes_xywh, np.float64).reshape(n, 4)
        scores = np.asarray(scores, np.float64)
        # Detections for images absent from the GT image list contribute
        # nothing to the protocol (pycocotools only iterates gt imgIds) —
        # drop them on ingestion.
        pos = np.searchsorted(self._img_ids_arr, image_ids)
        member = (pos < len(self._img_ids_arr)) & (
            self._img_ids_arr[np.minimum(pos, len(self._img_ids_arr) - 1)] == image_ids
        )
        if not member.all():
            image_ids, category_ids = image_ids[member], category_ids[member]
            boxes, scores = boxes[member], scores[member]
            n = len(image_ids)
            if n == 0:
                return
        if self._scored and any(int(i) in self._scored for i in np.unique(image_ids)):
            # Late add for a finalized image: throw away incremental state;
            # evaluate() rescores from the retained columnar detections.
            self._reset_scoring()
        order = np.lexsort((category_ids, image_ids))
        ii, cc = image_ids[order], category_ids[order]
        b, s = boxes[order], scores[order]
        change = np.flatnonzero((ii[1:] != ii[:-1]) | (cc[1:] != cc[:-1])) + 1
        starts = np.concatenate(([0], change))
        ends = np.concatenate((change, [n]))
        for st, en in zip(starts, ends):
            key = (int(ii[st]), int(cc[st]))
            self._dt_cols[key].append((b[st:en], s[st:en]))
            self._dt_cats_by_img[key[0]].add(key[1])

    # ----------------------------------------------------------------- score

    def _key_cols(self, key) -> tuple:
        chunks = self._dt_cols[key]
        if len(chunks) == 1:
            return chunks[0]
        return (
            np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
        )

    def score_images(self, img_ids: Iterable[int]) -> None:
        """Finalize per-detection TP/ignore flags for these images (their
        detections must be complete). Safe to call repeatedly; images
        already scored are skipped."""
        todo = [int(i) for i in img_ids if int(i) not in self._scored]
        if not todo:
            return
        self._scored.update(todo)

        full_keys: List[tuple] = []
        simple_keys: List[tuple] = []
        for img in todo:
            det_cats = self._dt_cats_by_img.get(img, ())
            for cat in det_cats:
                key = (img, cat)
                (full_keys if key in self._gt else simple_keys).append(key)
            for cat in self._gt_cats_by_img.get(img, ()):
                if cat not in det_cats:
                    # GT-only pair: contributes num_gt, no det rows.
                    _, crowd, area = self._gt[(img, cat)]
                    real = (
                        ~crowd[None, :]
                        & (area[None, :] >= _AREA_LO[:, None])
                        & (area[None, :] <= _AREA_HI[:, None])
                    )
                    self._num_gt[self._cat_rank[cat]] += real.sum(-1)
        if simple_keys:
            self._score_simple(simple_keys)
        if full_keys:
            self._score_full(full_keys)

    def _score_simple(self, keys: List[tuple]) -> None:
        """Pairs with detections but NO ground truth of that category in the
        image: nothing can match, so flags reduce to the detection-area gate.
        One vectorized pass over all such pairs."""
        parts_b, parts_s, parts_img, parts_cat = [], [], [], []
        for key in keys:
            b, s = self._key_cols(key)
            parts_b.append(b)
            parts_s.append(s)
            parts_img.append(np.full(len(s), key[0], np.int64))
            parts_cat.append(np.full(len(s), key[1], np.int64))
        b = np.concatenate(parts_b)
        s = np.concatenate(parts_s)
        img = np.concatenate(parts_img)
        cat = np.concatenate(parts_cat)
        img_rank = np.searchsorted(self._img_ids_arr, img).astype(np.int32)
        # cat-major, then image, then score desc; lexsort is stable so equal
        # scores keep ingestion order (pycocotools' stable sort).
        order = np.lexsort((-s, img_rank, cat))
        b, s, img_rank, cat = b[order], s[order], img_rank[order], cat[order]
        grp = np.flatnonzero((cat[1:] != cat[:-1]) | (img_rank[1:] != img_rank[:-1])) + 1
        starts = np.concatenate(([0], grp))
        counts = np.diff(np.concatenate((starts, [len(s)])))
        det_rank = (np.arange(len(s)) - np.repeat(starts, counts)).astype(np.int32)
        keep = det_rank < MAX_DETS
        b, s, img_rank, cat, det_rank = b[keep], s[keep], img_rank[keep], cat[keep], det_rank[keep]
        area = b[:, 2] * b[:, 3]
        d_out = (area[None, :] < _AREA_LO[:, None]) | (area[None, :] > _AREA_HI[:, None])  # [A,n]
        # Per-cat slices (cat-major after the sort): one chunk per category.
        cstart = np.concatenate(([0], np.flatnonzero(cat[1:] != cat[:-1]) + 1, [len(cat)]))
        for ci in range(len(cstart) - 1):
            st, en = cstart[ci], cstart[ci + 1]
            if st == en:
                continue
            self._acc[int(cat[st])].append(
                ("simple", s[st:en], img_rank[st:en], det_rank[st:en], d_out[:, st:en])
            )

    def _score_full(self, keys: List[tuple], chunk: int = 512) -> None:
        """Pairs with detections AND ground truth: batched greedy matcher."""
        keys = sorted(keys, key=lambda k: (self._cat_rank[k[1]], k[0]))
        for c0 in range(0, len(keys), chunk):
            self._score_full_chunk(keys[c0 : c0 + chunk])

    def _score_full_chunk(self, keys: List[tuple]) -> None:
        P = len(keys)
        d_list, g_list = [], []
        for key in keys:
            b, s = self._key_cols(key)
            o = np.argsort(-s, kind="stable")[:MAX_DETS]
            d_list.append((b[o], s[o]))
            g_list.append(self._gt[key])
        D = max(len(s) for _, s in d_list)
        G = max(len(c) for _, c, _ in g_list)
        d_boxes = np.zeros((P, D, 4))
        d_scores = np.full((P, D), -np.inf)
        d_count = np.zeros(P, np.int64)
        g_boxes = np.zeros((P, G, 4))
        g_crowd = np.zeros((P, G), bool)
        g_area = np.zeros((P, G))
        g_count = np.zeros(P, np.int64)
        for p, ((db, ds), (gb, gc, ga)) in enumerate(zip(d_list, g_list)):
            d_boxes[p, : len(ds)] = db
            d_scores[p, : len(ds)] = ds
            d_count[p] = len(ds)
            g_boxes[p, : len(gc)] = gb
            g_crowd[p, : len(gc)] = gc
            g_area[p, : len(gc)] = ga
            g_count[p] = len(gc)

        tp, ig, num_gt = _match_pairs(d_boxes, d_scores, d_count, g_boxes, g_crowd, g_area, g_count)

        for p, key in enumerate(keys):
            self._num_gt[self._cat_rank[key[1]]] += num_gt[p]
        # Flatten per-pair rows (keys are cat-major from _score_full's sort).
        img_rank = np.searchsorted(self._img_ids_arr, [k[0] for k in keys]).astype(np.int32)
        for p, key in enumerate(keys):
            n = int(d_count[p])
            if n == 0:
                continue
            self._acc[key[1]].append(
                (
                    "full",
                    d_scores[p, :n].copy(),
                    np.full(n, img_rank[p], np.int32),
                    np.arange(n, dtype=np.int32),
                    tp[p, :, :, :n].copy(),  # copies: don't pin the padded [P,A,T,D] block
                    ig[p, :, :, :n].copy(),
                )
            )

    # -------------------------------------------------------------- evaluate

    def _accumulate_cat(self, chunks: list, ki: int) -> Optional[np.ndarray]:
        """precision[A, T, R] for one category; None if no content."""
        if not chunks and not self._num_gt[ki].any():
            return None
        if chunks:
            scores = np.concatenate([c[1] for c in chunks])
            img_rank = np.concatenate([c[2] for c in chunks])
            det_rank = np.concatenate([c[3] for c in chunks])
            # Global order: score desc; ties by (image rank, per-image det
            # rank) — pycocotools' per-image concatenation order, so
            # incremental arrival order cannot change the result.
            order = np.lexsort((det_rank, img_rank, -scores))
            nd = len(scores)
            tp = np.empty((_NA, _NT, nd), bool)
            ig = np.empty((_NA, _NT, nd), bool)
            pos = 0
            for c in chunks:
                n = len(c[1])
                if c[0] == "simple":
                    tp[:, :, pos : pos + n] = False
                    ig[:, :, pos : pos + n] = c[4][:, None, :]
                else:
                    tp[:, :, pos : pos + n] = c[4]
                    ig[:, :, pos : pos + n] = c[5]
                pos += n
            tp = tp[:, :, order]
            ig = ig[:, :, order]
            tps = tp
            fps = ~tp & ~ig
            tp_sum = np.cumsum(tps, axis=2, dtype=np.float64)
            fp_sum = np.cumsum(fps, axis=2, dtype=np.float64)
        else:
            nd = 0

        precision = -np.ones((_NA, _NT, len(REC_THRS)))
        for ai in range(_NA):
            num_gt = int(self._num_gt[ki, ai])
            if num_gt == 0:
                continue
            if nd == 0:
                precision[ai] = 0.0
                continue
            rc = tp_sum[ai] / num_gt  # [T, nd]
            pr = tp_sum[ai] / np.maximum(tp_sum[ai] + fp_sum[ai], np.spacing(1))
            # Monotone precision envelope (right-to-left running max),
            # sampled at the 101 recall thresholds.
            env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
            for ti in range(_NT):
                inds = np.searchsorted(rc[ti], REC_THRS, side="left")
                ok = inds < nd
                q = np.zeros(len(REC_THRS))
                q[ok] = env[ti, inds[ok]]
                precision[ai, ti] = q
        return precision

    def evaluate(self) -> Dict[str, float]:
        """Returns the COCOeval headline stats for bbox."""
        remaining = [i for i in self.img_ids if i not in self._scored]
        if remaining:
            self.score_images(remaining)

        K = len(self.cat_ids)
        precision = -np.ones((_NA, _NT, len(REC_THRS), K))
        for ki, cat_id in enumerate(self.cat_ids):
            p = self._accumulate_cat(self._acc.get(cat_id, []), ki)
            if p is not None:
                precision[:, :, :, ki] = p

        def _mean(p):
            valid = p[p > -1]
            return float(valid.mean()) if valid.size else 0.0

        p_all = precision[0]
        stats = {
            "map_50_95": _mean(p_all),
            "map_50": _mean(p_all[0]),
            "map_75": _mean(p_all[5]),
        }
        for ai, area in enumerate(_AREA_ORDER[1:], start=1):
            stats[f"map_{area}"] = _mean(precision[ai])
        return stats
