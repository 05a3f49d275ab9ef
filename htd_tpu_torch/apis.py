"""Entry points: build a detector, single-image inference, test-time
augmentation, dataset evaluation and the DCN offset statistics.

Counterpart of `htd_tpu/apis.py` (`init_detector`, `inference_detector`,
`aug_inference_detector`, `evaluate_dataset`, `evaluate_proposals`,
`calibrate_dcn`; mmdet apis/inference.py and test.py). The model runs on
CUDA unless the caller asks for the CPU with `device="cpu"`; with no
device given and no GPU present the entry points raise rather than fall
back. `evaluate_dataset(group=...)` evaluates over the ranks of a
`torch.distributed` process group, one process per rank (the JAX
package's `mesh=` and multi-host evaluation): batches dealt round-robin,
detections gathered, every rank computing the metrics.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from htd_tpu_torch.config import HTDConfig
from htd_tpu_torch.data.pipeline import bucket_shape, preprocess
from htd_tpu_torch.models import tta
from htd_tpu_torch.models.detector import HTDDetector
from htd_tpu_torch.train.checkpoint import load_torch_checkpoint
from htd_tpu_torch.weights import init_random


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when none is given; raises when CUDA is missing."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    return dev


def init_detector(cfg: HTDConfig, checkpoint: Optional[str] = None, device=None,
                  seed: int = 0) -> HTDDetector:
    """Build the detector on `device` in `cfg.compute_dtype`, from a `.pth`
    when given (an mmdet checkpoint or one that `train.checkpoint.
    save_checkpoint` wrote; every tensor of the model, strictly), else with
    random weights drawn from `seed`."""
    dev = resolve_device(device)
    model = HTDDetector(cfg)
    if checkpoint:
        model.load_state_dict(load_torch_checkpoint(checkpoint))
    else:
        init_random(model, seed)
    model = model.to(device=dev, dtype=model.compute_dtype)
    model = model.to(memory_format=torch.channels_last)
    return model.eval()


@torch.inference_mode()
def inference_detector(model: HTDDetector, img_bgr: np.ndarray,
                       scale: Optional[Tuple[int, int]] = None):
    """Single-image inference. Returns (boxes (k, 4), scores (k,), labels
    (k,)) numpy arrays in original-image coordinates.

    `scale` defaults to the config's test scale; the image is padded into
    its orientation's static bucket."""
    scale = scale or model.cfg.test_scale
    landscape = img_bgr.shape[1] >= img_bgr.shape[0]
    p = preprocess(img_bgr, scale=scale, bucket=bucket_shape(scale, landscape),
                   device=model.device)
    dets = model.simple_test(p.image[None], p.img_shape[None], p.scale_factor[None])
    v = dets.valid[0].cpu().numpy()
    return (dets.boxes[0].cpu().numpy()[v], dets.scores[0].cpu().numpy()[v],
            dets.labels[0].cpu().numpy()[v])


@torch.inference_mode()
def aug_inference_detector(model: HTDDetector, img_bgr: np.ndarray,
                           scales: Optional[Sequence[Tuple[int, int]]] = None, flip: bool = True):
    """Multi-scale and flip test-time augmentation of one image (mmdet
    MultiScaleFlipAug and aug_test): augs are scales outer, [no flip, flip]
    inner; each aug's proposals are mapped back to the original frame and
    merged by NMS; each aug runs both cascade stages on the merged
    proposals mapped into its frame; the decoded boxes and softmax scores
    are mapped back and averaged, then the test config's multiclass NMS.
    Returns (boxes (k, 4), scores (k,), labels (k,)) numpy arrays in
    original-image coordinates. Each aug runs the backbone twice (the
    proposal pass and the cascade pass), as the JAX package does."""
    scales = scales or (model.cfg.test_scale,)
    landscape = img_bgr.shape[1] >= img_bgr.shape[0]
    augs = [preprocess(img_bgr, scale=scale, bucket=bucket_shape(scale, landscape),
                       device=model.device, flip=fl)
            for scale in scales for fl in ([False, True] if flip else [False])]

    prop_b, prop_s, prop_v = [], [], []
    for p in augs:
        boxes, scores, valid = model.rpn_proposals(p.image[None], p.img_shape[None])
        prop_b.append(tta.map_back(boxes[0], p.img_shape, p.scale_factor, p.flipped))
        prop_s.append(scores[0])
        prop_v.append(valid[0])
    merged, _, merged_valid = tta.merge_aug_proposals(prop_b, prop_s, prop_v,
                                                      model.cfg.proposal_test)

    aug_boxes, aug_scores = [], []
    for p in augs:
        rois = tta.map_into(merged, p.img_shape, p.scale_factor, p.flipped)
        boxes, scores = model.stages_forward(p.image[None], p.img_shape[None], rois[None],
                                             merged_valid[None])
        aug_boxes.append(tta.map_back(boxes[0], p.img_shape, p.scale_factor, p.flipped))
        aug_scores.append(scores[0])
    boxes, scores = tta.merge_aug_bboxes(aug_boxes, aug_scores)
    db, ds, dl, dv = tta.final_nms(boxes, scores, merged_valid, model.cfg.rcnn_test)
    v = dv.cpu().numpy()
    return db.cpu().numpy()[v], ds.cpu().numpy()[v], dl.cpu().numpy()[v]


@torch.inference_mode()
def evaluate_proposals(model: HTDDetector, dataset, batch_size: int = 8,
                       scale: Optional[Tuple[int, int]] = None, max_images: Optional[int] = None,
                       proposal_nums: Sequence[int] = (100, 300, 1000)) -> Dict[str, float]:
    """RPN proposal recall (mmdet 'proposal_fast': `eval_recalls` at IoU
    0.50:0.95 over the non-crowd gts, proposals rescaled to the original
    frame): {"AR@n": ...} for each n in `proposal_nums`."""
    # imported here: data.coco imports train.train_step, which imports this module
    from htd_tpu_torch.data.coco import grouped_batches, make_test_batch
    from htd_tpu_torch.data.mean_ap import eval_recalls

    scale = scale or model.cfg.test_scale
    gt = dataset.groundtruth()
    gts, props = [], []
    seen = 0
    for records in grouped_batches(dataset, batch_size, shuffle=False):
        if max_images is not None and seen >= max_images:
            break
        images, shapes, sfs, ids = make_test_batch(dataset, records, scale=scale,
                                                   batch_size=batch_size, device=model.device)
        boxes, scores, valid = (t.cpu().numpy() for t in model.rpn_proposals(images, shapes))
        sfs = sfs.cpu().numpy()
        for i, img_id in enumerate(ids):
            if img_id < 0:
                continue
            if max_images is not None and seen >= max_images:
                break  # the reported recall does not depend on batch_size
            m = valid[i]
            b = boxes[i][m] / sfs[i]
            props.append(np.concatenate([b, scores[i][m][:, None]], axis=1))
            g_boxes, _, g_crowd = gt[int(img_id)]
            gts.append(g_boxes[~g_crowd])
            seen += 1
    rec = eval_recalls(gts, props, proposal_nums, np.arange(0.5, 0.96, 0.05))
    return {f"AR@{n}": float(rec[i].mean()) for i, n in enumerate(proposal_nums)}


@torch.inference_mode()
def evaluate_dataset(model: HTDDetector, dataset, batch_size: int = 8,
                     scale: Optional[Tuple[int, int]] = None, max_images: Optional[int] = None,
                     log_every: int = 50, return_detections: bool = False, group=None):
    """COCO evaluation: batched bucket-padded inference (`simple_test`) over
    the dataset in orientation-homogeneous batches, then the COCO bbox
    metrics of `data.coco_eval.evaluate_coco_map` (mAP, mAP_50, mAP_75,
    mAP_s/m/l, AR@100). With `return_detections`, also img_id -> (boxes,
    scores, labels) in original-image coordinates.

    With a process `group` (`torch.distributed`), rank r of n runs the
    batches whose index is r mod n (`batch_size` is the rank's batch;
    `max_images` counts the rank's images), every rank's detections are
    padded to the same batch count with img_id -1 rows and gathered
    (`parallel.gather_detections`), and every rank returns the metrics of
    all of them (the reference's multi_gpu_test)."""
    from htd_tpu_torch.data.coco import grouped_batches, make_test_batch
    from htd_tpu_torch.data.coco_eval import evaluate_coco_map
    from htd_tpu_torch.parallel.dist import gather_detections, max_over_ranks, world

    scale = scale or model.cfg.test_scale
    if model.cfg.roi_extractor.max_samples < 8:
        print(f"[eval] model built with the serving RoIAlign preset (roi_extractor.max_samples="
              f"{model.cfg.roi_extractor.max_samples}); for exact mmcv sampling_ratio=0 "
              f"accuracy build with max_samples=8", file=sys.stderr)
    rank, size = world(group) if group is not None else (0, 1)
    detections: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    gathered = []
    seen = 0
    t0 = time.time()
    for bi, records in enumerate(grouped_batches(dataset, batch_size, shuffle=False)):
        if bi % size != rank:
            continue
        if max_images is not None and seen >= max_images:
            break
        images, shapes, sfs, ids = make_test_batch(dataset, records, scale=scale,
                                                   batch_size=batch_size, device=model.device)
        dets = model.simple_test(images, shapes, sfs)
        boxes, scores, labels, valid = (t.cpu().numpy() for t in dets)
        if group is not None:
            # the dtypes of the padding rows below, on every rank
            gathered.append((boxes.astype(np.float32), scores.astype(np.float32),
                             labels.astype(np.int32), valid.astype(bool), ids))
        for i, img_id in enumerate(ids):
            if img_id < 0:
                continue
            m = valid[i]
            detections[int(img_id)] = (boxes[i][m], scores[i][m], labels[i][m])
            seen += 1
        if log_every and seen % log_every < batch_size and rank == 0:
            print(f"[eval] {seen} imgs, {seen / max(time.time() - t0, 1e-9):.2f} img/s")
    if group is not None:
        # every rank pads to the same batch count, so that the gathered
        # arrays have one shape
        n_batches = max_over_ranks(len(gathered), group)
        p = model.cfg.rcnn_test.max_per_img
        while len(gathered) < n_batches:
            gathered.append((np.zeros((batch_size, p, 4), np.float32),
                             np.zeros((batch_size, p), np.float32),
                             np.zeros((batch_size, p), np.int32),
                             np.zeros((batch_size, p), bool), np.full(batch_size, -1, np.int64)))
        boxes, scores, labels, valid, ids = gather_detections(
            *(np.concatenate([g[j] for g in gathered]) for j in range(5)), group=group)
        # rank r's k-th batch is batch k * size + r: back into the dataset's order
        order = np.arange(len(ids)).reshape(size, n_batches, batch_size).transpose(1, 0, 2)
        detections = {}
        for i in order.reshape(-1):
            if ids[i] >= 0:
                m = valid[i]
                detections[int(ids[i])] = (boxes[i][m], scores[i][m], labels[i][m])
    gt = {k: v for k, v in dataset.groundtruth().items() if k in detections}
    metrics = evaluate_coco_map(detections, gt, num_classes=len(dataset.cat_ids) or 80)
    return (metrics, detections) if return_detections else metrics


@torch.inference_mode()
def calibrate_dcn(model: HTDDetector, images, window: Tuple[int, int] = (-1, 1)):
    """Per deformable conv, the offset statistics of the JAX package's
    `calibrate_dcn` on `images` (one (N, H, W, 3) normalized batch, numpy
    or tensor, or an iterable of them): the share of output pixels with a
    sample whose floor displacement leaves `window`, the most such pixels
    in one image, and the 99th percentile of |offset|. Returns (per_conv,
    recommendation) with per_conv keyed "layer{s}_{i}". The TPU kernel
    needed the recommendation to pick its window and correction cap; the
    port's K3 is exact for every offset, so the recommendation is always
    {"impl": "exact", "fb_cap": None} and changes nothing."""
    batches = [images] if hasattr(images, "shape") else list(images)
    captured = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: captured.append(
            (name, out.permute(0, 2, 3, 1).float().cpu().numpy())))
        for name, m in model.named_modules() if name.endswith(".conv_offset")]
    try:
        for batch in batches:
            model.extract_feats(torch.as_tensor(batch))
    finally:
        for h in hooks:
            h.remove()
    return _dcn_offset_stats(captured, window), {"impl": "exact", "fb_cap": None}


def _dcn_offset_stats(captured, window):
    """The per-conv part of the JAX package's `_dcn_offset_stats` over
    (module name, (N, Ho, Wo, 18) offsets) pairs, aggregated over calls."""
    lo, hi = window
    per_conv = {}
    for path, off in captured:
        n, h, w = off.shape[:3]
        o = off.reshape(n, h, w, -1, 2)
        disp = np.floor(o)
        flagged = ((disp < lo) | (disp > hi)).any(axis=(3, 4))
        per_img = flagged.reshape(n, -1).sum(axis=1)
        name = "_".join(path.split(".")[1:3])          # backbone.layer2.0.conv2... -> layer2_0
        st = per_conv.setdefault(name, {"flag_rate": 0.0, "flagged_px_per_img_p100": 0,
                                        "abs_off_p99": 0.0, "_n": 0})
        k = st["_n"]
        st["flag_rate"] = (st["flag_rate"] * k + float(flagged.mean()) * n) / (k + n)
        st["flagged_px_per_img_p100"] = max(st["flagged_px_per_img_p100"], int(per_img.max()))
        st["abs_off_p99"] = max(st["abs_off_p99"], float(np.percentile(np.abs(o), 99)))
        st["_n"] = k + n
    for st in per_conv.values():
        st.pop("_n")
    return per_conv
