#!/usr/bin/env python
"""COCO error analysis: per-category stacked PR curves (C75/C50/Loc/Sim/
Oth/BG/FN).

The PyTorch port's copy of tools/coco_error_analysis.py, over the port's
evaluator (htd_tpu_torch.data.coco_eval.precision_curves, no pycocotools).
Takes a standard COCO results json (tools_torch/test.py --coco-dump) plus the
annotation json and writes one stacked-PR png per (category, area) and the
allclass aggregate (drawn in numpy and written by `data.png.write_png`, so
that it needs no plotting library; the legend's APs are printed), with the
same error decomposition (reference :52-153):

  C75  — precision at IoU 0.75,
  C50  — precision at IoU 0.50,
  Loc  — IoU 0.10 (localization errors forgiven),
  Sim  — IoU 0.10 with same-supercategory confusions ignored,
  Oth  — IoU 0.10 with ALL class confusions ignored,
  BG   — background false positives removed (1 wherever Oth > 0),
  FN   — all remaining errors removed (always 1).

Each successive curve forgives one more error source; the stacked area
between consecutive curves is that error's AP cost.
"""

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

AREA_NAMES = ["allarea", "small", "medium", "large"]
TYPES = ["C75", "C50", "Loc", "Sim", "Oth", "BG", "FN"]
# stack fill colors, reference :13-20 (white, white, purple-blue, red,
# green, purple, orange)
COLORS = [
    (1.0, 1.0, 1.0), (1.0, 1.0, 1.0), (0.31, 0.51, 0.74),
    (0.75, 0.31, 0.30), (0.36, 0.90, 0.38), (0.50, 0.39, 0.64),
    (1.0, 0.6, 0.0),
]


def load_coco_gt(ann_file):
    """-> (groundtruth dict for the evaluator, cat list [(id, name, super)])."""
    with open(ann_file) as f:
        data = json.load(f)
    cats = [
        (c["id"], c["name"], c.get("supercategory", c["name"]))
        for c in data.get("categories", [])
    ]
    cat2label = {cid: i for i, (cid, _, _) in enumerate(cats)}
    img_sizes = {im["id"]: (im["width"], im["height"]) for im in data["images"]}
    per_img = defaultdict(lambda: ([], [], []))
    for a in data.get("annotations", []):
        if a.get("ignore", False):
            continue
        w_img, h_img = img_sizes[a["image_id"]]
        x, y, w, h = a["bbox"]
        x1, y1 = max(x, 0.0), max(y, 0.0)
        x2, y2 = min(x + w, w_img), min(y + h, h_img)
        if x2 <= x1 or y2 <= y1:
            continue
        b, l, c = per_img[a["image_id"]]
        b.append([x1, y1, x2, y2])
        l.append(cat2label[a["category_id"]])
        c.append(bool(a.get("iscrowd", 0)))
    gt = {}
    for img_id in img_sizes:
        b, l, c = per_img.get(img_id, ([], [], []))
        gt[img_id] = (
            np.asarray(b, np.float64).reshape(-1, 4),
            np.asarray(l, np.int64),
            np.asarray(c, bool),
        )
    return gt, cats


def load_coco_results(res_file, cat2label):
    """COCO results json (xywh) -> detections dict for the evaluator."""
    with open(res_file) as f:
        results = json.load(f)
    per_img = defaultdict(lambda: ([], [], []))
    for r in results:
        b, s, l = per_img[r["image_id"]]
        x, y, w, h = r["bbox"]
        b.append([x, y, x + w, y + h])
        s.append(r["score"])
        l.append(cat2label[r["category_id"]])
    return {
        k: (
            np.asarray(b, np.float64).reshape(-1, 4),
            np.asarray(s, np.float64),
            np.asarray(l, np.int64),
        )
        for k, (b, s, l) in per_img.items()
    }


def _relabel_ignored(gt, target, cat_set):
    """GT variant where every annotation with label in `cat_set` (except
    `target`) becomes an ignore region of class `target` — the reference's
    ignore=1/iscrowd=1 relabeling (:67-90); our evaluator treats crowd as
    ignore-with-IoF, exactly pycocotools' handling of those anns."""
    out = {}
    for img, (b, l, c) in gt.items():
        conf = np.isin(l, list(cat_set)) & (l != target)
        keep_or_conf = conf | (l == target)
        out[img] = (
            b[keep_or_conf],
            np.where(conf[keep_or_conf], target, l[keep_or_conf]),
            c[keep_or_conf] | conf[keep_or_conf],
        )
    return out


def analyze_category(dets, gt, k, same_super, all_cats):
    """-> ps (7, R, A) stacked curves for category index k."""
    from htd_tpu_torch.data.coco_eval import precision_curves

    base = precision_curves(dets, gt, [k], iou_thrs=np.array([0.75, 0.5, 0.1]))
    ps = np.zeros((7,) + base.shape[1:2] + base.shape[3:])  # (7, R, A)
    ps[0] = base[0, :, 0]  # C75
    ps[1] = base[1, :, 0]  # C50
    ps[2] = base[2, :, 0]  # Loc @0.1
    gt_sim = _relabel_ignored(gt, k, same_super)
    ps[3] = precision_curves(dets, gt_sim, [k], iou_thrs=np.array([0.1]))[0, :, 0]
    gt_oth = _relabel_ignored(gt, k, all_cats)
    ps[4] = precision_curves(dets, gt_oth, [k], iou_thrs=np.array([0.1]))[0, :, 0]
    ps[ps == -1] = 0
    ps[5] = ps[4] > 0  # BG removed
    ps[6] = 1.0        # FN removed
    return ps


def render(rec_thrs, curves, height: int = 500, width: int = 600) -> np.ndarray:
    """The stacked PR plot of (7, R) `curves` as (height, width, 3) uint8
    BGR: the area under curve t over curve t - 1 in COLORS[t] (white under
    C75 and C50), each curve as a black line, the axes box in black,
    recall across [0, 1] and precision up [0, 1]."""
    x0, y0, x1, y1 = 50, 20, width - 20, height - 40     # plot box
    recall = np.linspace(0.0, 1.0, x1 - x0)
    prec = np.linspace(1.0, 0.0, y1 - y0)
    at = np.stack([np.interp(recall, rec_thrs, c) for c in curves])     # (7, pw)
    # per pixel, the number of curves below its precision: its band's index
    band = (prec[:, None, None] > at.T[None]).sum(-1)                   # (ph, pw)
    palette = (np.array(COLORS + [(1.0, 1.0, 1.0)])[:, ::-1] * 255).round().astype(np.uint8)
    img = np.full((height, width, 3), 255, np.uint8)
    img[y0:y1, x0:x1] = palette[np.minimum(band, len(COLORS))]
    edge = np.zeros_like(band, bool)
    edge[1:] = band[1:] != band[:-1]
    img[y0:y1, x0:x1][edge] = 0
    img[y0:y1 + 1, [x0 - 1, x1]] = 0
    img[[y0 - 1, y1], x0 - 1:x1 + 1] = 0
    return img


def makeplot(rec_thrs, ps, out_dir, class_name):
    """Stacked PR plot per area range (`render`, written by the port's
    `write_png`, no plotting library); ps is (7, R, A). Prints each plot's
    legend: the mean of each curve, as the reference's legend gives it."""
    from htd_tpu_torch.data.png import write_png

    for ai, area in enumerate(AREA_NAMES):
        title = f"bbox-{class_name}-{area}"
        curves = [ps[t, :, ai] for t in range(7)]
        write_png(os.path.join(out_dir, f"{title}.png"), render(rec_thrs, curves))
        print(f"[error-analysis] {title}: " + " ".join(
            f"[{c.mean():.3f}]{name}" for c, name in zip(curves, TYPES)))


def analyze_results(res_file, ann_file, out_dir, max_cats=None):
    os.makedirs(out_dir, exist_ok=True)
    gt, cats = load_coco_gt(ann_file)
    cat2label = {cid: i for i, (cid, _, _) in enumerate(cats)}
    dets = load_coco_results(res_file, cat2label)
    from htd_tpu_torch.data.coco_eval import REC_THRS

    supers = defaultdict(set)
    for i, (_, _, sup) in enumerate(cats):
        supers[sup].add(i)
    all_cats = set(range(len(cats)))

    ps_sum = None
    n = len(cats) if max_cats is None else min(max_cats, len(cats))
    for k in range(n):
        _, name, sup = cats[k]
        print(f"[error-analysis] {k + 1}/{n} {name}")
        ps = analyze_category(dets, gt, k, supers[sup], all_cats)
        makeplot(REC_THRS, ps, out_dir, name)
        ps_sum = ps if ps_sum is None else ps_sum + ps
    if ps_sum is not None and n:
        makeplot(REC_THRS, ps_sum / n, out_dir, "allclass")
    return ps_sum


def main(argv=None):
    """Returns the curves summed over the analysed categories, (7, R, A)."""
    p = argparse.ArgumentParser(description="COCO error analysis")
    p.add_argument("result", help="COCO results json (tools_torch/test.py --coco-dump)")
    p.add_argument("out_dir", help="directory for the PR pngs")
    p.add_argument("--ann", required=True, help="annotation json")
    p.add_argument("--max-cats", type=int, default=None,
                   help="analyze only the first N categories")
    args = p.parse_args(argv)
    return analyze_results(args.result, args.ann, args.out_dir, max_cats=args.max_cats)


if __name__ == "__main__":
    main()
