"""The comparisons that decide `correct`: numbers over the program's outputs
and the reference's, each then held to its limit.

Detections. For each sampled request the reference runs the same image
with the configuration's test settings (`strict`) and with relaxed ones
(three times `max_per_img`, half `score_thr`: a superset in the same
emission order, so that a detection the program kept near a cut still
finds its reference twin). Two detections are twins when their labels
agree and their IoU is at least MATCH_IOU. A program detection's twin is
the relaxed reference detection, among its twins, whose score lies
nearest its own. Compared, each pooled over the sampled requests:

- `score_rel_p90`: the 90th percentile of the twinned program
  detections' score gaps, each over its twin's score (1 where the
  reference detects something and the program twins nothing, 0 where
  neither detects anything);
- `unmatched`: the share of the program's detections with no twin among
  the relaxed reference's (a label or a box altered where it is made);
- `missed`: the share of the strict reference's detections with no twin
  among the program's (detections dropped, or a cut made early);
- `box_gap_p90`: the 90th percentile of 1 - IoU between each twinned
  program detection and its twin (boxes moved by less than the twin
  test lets through).

`matched`, the count of twinned program detections, is printed and not
compared.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MATCH_IOU = 0.5


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-6)


Dets = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _dets(d: Dets) -> Dets:
    b, s, lab = d
    return (np.asarray(b, np.float64).reshape(-1, 4), np.asarray(s, np.float64),
            np.asarray(lab).astype(np.int64))


def twins(a: Dets, b: Dets) -> np.ndarray:
    """(len(a), len(b)) IoU where the labels agree and the IoU reaches
    MATCH_IOU, else 0."""
    (ab, _, al), (bb, _, bl) = a, b
    if not len(ab) or not len(bb):
        return np.zeros((len(ab), len(bb)))
    iou = iou_matrix(ab, bb)
    return np.where((al[:, None] == bl[None, :]) & (iou >= MATCH_IOU), iou, 0.0)


def detection_numbers(pairs: Sequence[Tuple[Dets, Dets, Dets]]) -> Dict[str, float]:
    """pairs: (program, strict reference, relaxed reference) detections of
    each sampled request, each (boxes (k, 4), scores (k,), labels (k,))."""
    rel: List[np.ndarray] = []
    box: List[np.ndarray] = []
    n_prog = n_unmatched = n_strict = n_missed = 0
    for prog, strict, relaxed in pairs:
        prog, strict, relaxed = _dets(prog), _dets(strict), _dets(relaxed)
        ps, rs = prog[1], relaxed[1]
        iou = twins(prog, relaxed)
        gap = np.where(iou > 0, np.abs(ps[:, None] - rs[None, :]), np.inf)
        if gap.size:
            j = gap.argmin(axis=1)
            g = gap[np.arange(len(ps)), j]
            matched = np.isfinite(g)
            rel.append(g[matched] / rs[j[matched]])
            box.append(1.0 - iou[np.arange(len(ps)), j][matched])
            n_unmatched += int((~matched).sum())
        else:
            n_unmatched += len(ps)
        n_prog += len(ps)
        n_strict += len(strict[1])
        n_missed += int((twins(strict, prog).max(axis=1, initial=0.0) == 0).sum())
    rel_all = np.concatenate(rel) if rel else np.zeros(0)
    box_all = np.concatenate(box) if box else np.zeros(0)
    empty = 0.0 if n_strict == 0 and n_prog == 0 else 1.0
    return {"score_rel_p90": float(np.percentile(rel_all, 90)) if len(rel_all) else empty,
            "unmatched": n_unmatched / n_prog if n_prog else 0.0,
            "missed": n_missed / n_strict if n_strict else 0.0,
            "box_gap_p90": float(np.percentile(box_all, 90)) if len(box_all) else empty,
            "matched": float(len(rel_all))}


def held(numbers: Dict[str, float], limits: Dict[str, dict],
         failed: int = 0) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """Each compared number beside its limit, and whether all are within.
    The run's failed requests or steps are compared too, with the limit 0."""
    rows = [(k, float(numbers[k]), float(v["limit"])) for k, v in limits.items()]
    rows.append(("failed", float(failed), 0.0))
    ok = all(np.isfinite(val) and val <= lim for _, val, lim in rows)
    return ok, rows
