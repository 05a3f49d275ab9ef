"""The plain reference's operations: float32 PyTorch, no kernel, no cache.

The semantics are HTD's as its published configs and mmdet/mmcv define
them (RoIAlign(aligned=True) with the adaptive grid clamped as the config
says, DCNv1, greedy and linear-soft NMS, cv2's INTER_LINEAR resize). The
arithmetic that decides discrete things (floors, grid counts, IoU tests)
is written in the order the detector under test writes it, so that a
float32 run of the two agrees at those decisions; everything else is
plain. Nothing here imports the program under test.

`Precision` is the control's switch: "float32" is the reference; "fp8"
rounds the two operands of every convolution and matrix product to
float8 e4m3 with a per-tensor scale, and each product's result to
bfloat16, as an fp8 deployment computes; "bfloat16" rounds operands and
results to bfloat16.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = float("-inf")
F32 = torch.float32
FP8_MAX = 448.0


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        if self.name == "bfloat16":
            q = t.detach().to(torch.bfloat16).to(F32)
        else:
            d = t.detach()
            scale = FP8_MAX / d.abs().amax().clamp(min=1e-30)
            q = (d * scale).to(torch.float8_e4m3fn).to(F32) / scale
        return t + (q - t.detach())          # straight through for the gradient

    def result(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        return t + (t.detach().to(torch.bfloat16).to(F32) - t.detach())


def conv2d(x, w, b, prec: Precision, stride: int = 1, padding: int = 0, groups: int = 1):
    y = F.conv2d(prec.operand(x), prec.operand(w), b, stride=stride, padding=padding,
                 groups=groups)
    return prec.result(y)


def linear(x, w, b, prec: Precision):
    return prec.result(F.linear(prec.operand(x), prec.operand(w), b))


def matmul(a, b, prec: Precision):
    return prec.result(prec.operand(a) @ prec.operand(b))


# ---------------------------------------------------------------------------
# image preprocessing: mmcv rescale, cv2 INTER_LINEAR for uint8, normalize, pad
# ---------------------------------------------------------------------------

MEAN_RGB = (123.675, 116.28, 103.53)
STD_RGB = (58.395, 57.12, 57.375)


def rescale_size(h: int, w: int, scale: Sequence[int]) -> Tuple[int, int]:
    long_side, short_side = max(scale), min(scale)
    factor = min(long_side / max(h, w), short_side / min(h, w))
    return int(h * factor + 0.5), int(w * factor + 0.5)


def ceil32(x: int) -> int:
    return int(math.ceil(x / 32.0) * 32)


def bucket_shape(scale: Sequence[int], landscape: bool) -> Tuple[int, int]:
    long_side, short_side = max(scale), min(scale)
    return (ceil32(short_side), ceil32(long_side)) if landscape else \
        (ceil32(long_side), ceil32(short_side))


def _linear_taps(src: int, dst: int, clamp_frac: bool):
    """cv2's INTER_LINEAR table for one axis: first and second source index
    and the two 11-bit fixed-point coefficients."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_frac:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    a0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int32)
    a1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1


def resize_linear_u8(img: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> float32 holding what cv2.resize(INTER_LINEAR) gives."""
    h, w = int(img.shape[0]), int(img.shape[1])
    dev = img.device
    x0, x1, a0, a1 = (torch.from_numpy(a).to(dev) for a in _linear_taps(w, new_w, True))
    y0, y1, b0, b1 = (torch.from_numpy(a).to(dev) for a in _linear_taps(h, new_h, False))
    src = img.to(torch.int32)
    rows = src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]
    top = (b0[:, None, None] * (rows[y0] >> 4)) >> 16
    bottom = (b1[:, None, None] * (rows[y1] >> 4)) >> 16
    return ((top + bottom + 2) >> 2).clamp(0, 255).to(F32)


def preprocess(img_bgr: np.ndarray, scale: Sequence[int], bucket: Sequence[int], device,
               flip: bool = False):
    """(H, W, 3) uint8 BGR -> (normalized padded (Hb, Wb, 3) RGB image,
    (new_h, new_w), scale factors (w, h, w, h))."""
    img = torch.as_tensor(np.ascontiguousarray(img_bgr)).to(device)
    h, w = int(img.shape[0]), int(img.shape[1])
    new_h, new_w = rescale_size(h, w, scale)
    x = resize_linear_u8(img, new_h, new_w)
    if flip:
        x = x.flip(1)
    x = x.flip(-1)
    mean = torch.tensor(MEAN_RGB, dtype=F32, device=x.device)
    std = torch.tensor(STD_RGB, dtype=F32, device=x.device)
    x = (x - mean) / std
    out = torch.zeros((bucket[0], bucket[1], 3), dtype=F32, device=x.device)
    out[:new_h, :new_w] = x
    sf = (new_w / w, new_h / h, new_w / w, new_h / h)
    return out, (new_h, new_w), sf


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def _consts(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def bbox2delta(p, g, means=(0.0,) * 4, stds=(1.0,) * 4):
    px, py = (p[..., 0] + p[..., 2]) * 0.5, (p[..., 1] + p[..., 3]) * 0.5
    pw, ph = p[..., 2] - p[..., 0], p[..., 3] - p[..., 1]
    gx, gy = (g[..., 0] + g[..., 2]) * 0.5, (g[..., 1] + g[..., 3]) * 0.5
    gw, gh = g[..., 2] - g[..., 0], g[..., 3] - g[..., 1]
    d = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph)],
                    dim=-1)
    return (d - _consts(means, d)) / _consts(stds, d)


def clip_boxes(boxes, h, w):
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def delta2bbox(rois, deltas, means=(0.0,) * 4, stds=(1.0,) * 4, max_hw=None):
    """mmdet DeltaXYWHBBoxCoder.decode, clipped to `max_hw` = (h, w) tensors
    that broadcast against rois[..., 0]."""
    d = deltas * _consts(stds, deltas) + _consts(means, deltas)
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(16.0 / 1000.0))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px, py = (rois[..., 0] + rois[..., 2]) * 0.5, (rois[..., 1] + rois[..., 3]) * 0.5
    pw, ph = rois[..., 2] - rois[..., 0], rois[..., 3] - rois[..., 1]
    gw, gh = pw * torch.exp(dw), ph * torch.exp(dh)
    gx, gy = px + pw * dx, py + ph * dy
    boxes = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    return boxes if max_hw is None else clip_boxes(boxes, *max_hw)


def box_iou(a, b, eps: float = 1e-6):
    """Pairwise IoU of (..., M, 4) and (..., N, 4)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=eps)


def roi_levels(boxes, num_levels: int, finest_scale: float = 56.0):
    """mmdet's level map floor(log2(sqrt(area) / 56 + 1e-6)), clamped."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    s = torch.sqrt((w * h).clamp(min=0))
    lvl = torch.floor(torch.log2(s / torch.full_like(s, finest_scale) + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int64)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def nms(boxes, scores, thr: float, max_out: int):
    """Greedy hard NMS (suppress IoU > thr), score order with ties by index;
    -inf scores are absent. Returns (idx, score, valid), each (max_out,)."""
    dev = boxes.device
    order = torch.sort(scores.to(F32), descending=True, stable=True).indices
    sb, ss = boxes[order].to(F32), scores[order].to(F32)
    n = int((ss > NEG_INF).sum())
    iou = box_iou(sb[:n], sb[:n]) if n else torch.zeros((0, 0), device=dev)
    over = (iou > thr).cpu().numpy()
    alive = np.ones(n, bool)
    kept = []
    for i in range(n):
        if not alive[i]:
            continue
        kept.append(i)
        if len(kept) == max_out:
            break
        alive[i + 1:] &= ~over[i, i + 1:]
    idx = torch.zeros(max_out, dtype=torch.int64, device=dev)
    sc = torch.full((max_out,), NEG_INF, dtype=F32, device=dev)
    if kept:
        k = torch.tensor(kept, dtype=torch.int64, device=dev)
        idx[:len(kept)] = order[k]
        sc[:len(kept)] = ss[k]
    valid = sc > NEG_INF
    return idx, sc, valid


def soft_nms_linear(boxes, scores, thr: float, min_score: float, max_out: int):
    """mmcv linear soft-NMS: emit the highest live score (first on ties),
    decay live boxes with IoU > thr by (1 - IoU), drop those below
    min_score. Same return contract as `nms`, in emission order."""
    dev = boxes.device
    boxes = boxes.to(F32)
    live = scores.to(F32).clone()
    live[live < min_score] = NEG_INF
    idx = torch.zeros(max_out, dtype=torch.int64, device=dev)
    sc = torch.full((max_out,), NEG_INF, dtype=F32, device=dev)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for r in range(max_out):
        j = int(torch.argmax(live))
        s = live[j]
        if not bool(s > NEG_INF):
            break
        lt = torch.maximum(boxes[j, :2], boxes[:, :2])
        rb = torch.minimum(boxes[j, 2:], boxes[:, 2:])
        wh = (rb - lt).clamp(min=0)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / (area[j] + area - inter).clamp(min=1e-6)
        live = live * torch.where(iou > thr, 1.0 - iou, torch.ones_like(iou))
        live[live < min_score] = NEG_INF
        live[j] = NEG_INF
        idx[r], sc[r] = j, s
    return idx, sc, sc > NEG_INF


def offset_by_class(boxes, scores, ids):
    """The class-offset trick: boxes of different ids never overlap."""
    finite = torch.isfinite(scores)[:, None]
    top = torch.where(finite, boxes, torch.zeros_like(boxes)).max()
    return boxes + ids.to(boxes.dtype)[:, None] * (top + 1.0)


def multiclass_nms(boxes, scores, score_thr, iou_thr, max_per_img, soft: bool,
                   soft_min_score: float, candidate_cap: int = 2048):
    """mmdet multiclass_nms over class-agnostic boxes (N, 4) and scores
    (N, C + 1), background last: the top `candidate_cap` (roi, class) scores
    above score_thr, then class-offset NMS. Returns boxes, scores, labels of
    the kept detections."""
    n, c1 = scores.shape
    c = c1 - 1
    flat = scores[:, :c].reshape(-1).to(F32)
    flat = torch.where(flat > score_thr, flat, torch.full_like(flat, NEG_INF))
    cap = min(candidate_cap, n * c)
    top = torch.sort(flat, descending=True, stable=True)
    ts, ti = top.values[:cap], top.indices[:cap]
    roi, cls = ti // c, ti % c
    cb = boxes[roi]
    ob = offset_by_class(cb, ts, cls)
    if soft:
        keep, ks, kv = soft_nms_linear(ob, ts, iou_thr, soft_min_score, max_per_img)
    else:
        keep, ks, kv = nms(ob, ts, iou_thr, max_per_img)
    return cb[keep][kv], ks[kv], cls[keep][kv]


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------

def base_anchors(stride: int, ratios, scales) -> np.ndarray:
    ratios = np.asarray(ratios, np.float32)
    scales = np.asarray(scales, np.float32)
    hr = np.sqrt(ratios)
    wr = 1.0 / hr
    ws = (stride * wr[:, None] * scales[None, :]).reshape(-1)
    hs = (stride * hr[:, None] * scales[None, :]).reshape(-1)
    return np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], -1).astype(np.float32)


def grid_anchors(stride: int, ratios, scales, fh: int, fw: int, device) -> torch.Tensor:
    """(fh * fw * A, 4) anchors, location-major, anchor index fastest."""
    sx, sy = np.meshgrid(np.arange(fw, dtype=np.float32) * stride,
                         np.arange(fh, dtype=np.float32) * stride)
    shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return torch.from_numpy((shifts + base_anchors(stride, ratios, scales)[None])
                            .reshape(-1, 4)).to(device)


def anchor_valid(stride: int, fh: int, fw: int, num_anchors: int, pad_h, pad_w, device):
    """Anchors whose cell lies inside ceil(pad / stride)."""
    vh = min(int(math.ceil(pad_h / stride)), fh)
    vw = min(int(math.ceil(pad_w / stride)), fw)
    cell = (torch.arange(fh, device=device)[:, None] < vh) & \
        (torch.arange(fw, device=device)[None, :] < vw)
    return cell.reshape(-1).repeat_interleave(num_anchors)


# ---------------------------------------------------------------------------
# RoIAlign on one level map
# ---------------------------------------------------------------------------

def roi_align(feat: torch.Tensor, rois: torch.Tensor, stride: int, out: int, max_samples: int,
              chunk_bytes: int = 256 << 20) -> torch.Tensor:
    """mmcv RoIAlign(aligned=True, sampling_ratio=0) of (R, 4) rois on one
    (H, W, C) map, with the adaptive grid ceil(bin) clamped at max_samples:
    -> (R, out, out, C). Samples outside [-1, size] count zero; the others
    are clamped into the map; each bin averages over max(gh * gw, 1)."""
    h, w, c = feat.shape
    r = rois.shape[0]
    if r == 0:
        return feat.new_zeros((0, out, out, c))
    s = max_samples
    dev = rois.device
    scale = 1.0 / stride
    rois = rois.to(F32)
    start_w = rois[:, 0] * scale - 0.5
    start_h = rois[:, 1] * scale - 0.5
    out_t = torch.full((r,), float(out), dtype=F32, device=dev)
    bin_w = (rois[:, 2] - rois[:, 0]) * scale / out_t
    bin_h = (rois[:, 3] - rois[:, 1]) * scale / out_t
    gw = torch.ceil(bin_w).clamp(0, s).to(torch.int32)
    gh = torch.ceil(bin_h).clamp(0, s).to(torch.int32)
    p = torch.arange(out, dtype=F32, device=dev)
    i = torch.arange(s, dtype=F32, device=dev)
    gwf = gw.clamp(min=1).to(F32)[:, None, None]
    ghf = gh.clamp(min=1).to(F32)[:, None, None]
    xs = start_w[:, None, None] + (p[None, :, None] + (i[None, None, :] + 0.5) / gwf) * \
        bin_w[:, None, None]
    ys = start_h[:, None, None] + (p[None, :, None] + (i[None, None, :] + 0.5) / ghf) * \
        bin_h[:, None, None]
    mx = i[None, None, :] < gw.to(F32)[:, None, None]
    my = i[None, None, :] < gh.to(F32)[:, None, None]

    def axis(coord, size):
        size = torch.tensor(float(size), dtype=F32, device=dev)
        inside = (coord >= -1.0) & (coord <= size)
        cc = coord.clamp(min=0.0)
        low = torch.minimum(torch.floor(cc), size - 1.0)
        high = torch.minimum(low + 1.0, size - 1.0)
        frac = torch.where(cc >= size - 1.0, torch.zeros_like(cc), cc - low)
        return low.long(), high.long(), frac, inside

    xl, xh, lx, xin = axis(xs, w)
    yl, yh, ly, yin = axis(ys, h)
    k = 2 * s
    wy = (torch.stack([1.0 - ly, ly], -1) * (my & yin)[..., None].to(F32)).reshape(r, out, k)
    wx = (torch.stack([1.0 - lx, lx], -1) * (mx & xin)[..., None].to(F32)).reshape(r, out, k)
    iy = torch.stack([yl, yh], -1).reshape(r, out, k)
    ix = torch.stack([xl, xh], -1).reshape(r, out, k)
    wgt = (wy[:, :, None, :, None] * wx[:, None, :, None, :]).reshape(r, out, out, k * k)
    idx = (iy[:, :, None, :, None] * w + ix[:, None, :, None, :]).reshape(r, out, out, k * k)
    count = (gh * gw).clamp(min=1).to(F32)
    flat = feat.reshape(h * w, c)
    per_roi = out * out * k * k * c * 4
    step = max(1, chunk_bytes // per_roi)
    res = []
    for a in range(0, r, step):
        v = flat[idx[a:a + step].reshape(-1)].reshape(idx[a:a + step].shape + (c,)).to(F32)
        res.append(torch.einsum("rhwk,rhwkc->rhwc", wgt[a:a + step], v))
    return torch.cat(res) / count[:, None, None, None]


def roi_align_mapped(levels: List[torch.Tensor], rois: torch.Tensor, lvls: torch.Tensor,
                     strides, out: int, max_samples: int) -> torch.Tensor:
    """Each of (R, 4) rois on its own level of `levels` (each (H, W, C))."""
    res = levels[0].new_zeros((rois.shape[0], out, out, levels[0].shape[-1]), dtype=F32)
    for lv, (feat, stride) in enumerate(zip(levels, strides)):
        sel = torch.nonzero(lvls == lv)[:, 0]
        if sel.numel():
            res = res.index_put((sel,), roi_align(feat, rois[sel], stride, out, max_samples))
    return res


# ---------------------------------------------------------------------------
# deformable convolution v1 (3x3, padding 1)
# ---------------------------------------------------------------------------

def deform_conv(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, stride: int,
                prec: Precision, groups: int = 1, deform_groups: int = 1) -> torch.Tensor:
    """mmcv DeformConv2d (DCNv1): x (N, Cin, H, W), offsets (N, dg * 18, Ho,
    Wo) ordered [group][tap][(y, x)], weight (Cout, Cin / groups, 3, 3) ->
    (N, Cout, Ho, Wo). Each tap's sample is base + offset, bilinear with
    zero outside the map (a sample counts when -1 < y < H and -1 < x < W,
    each corner only inside)."""
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    ho, wo = offsets.shape[2], offsets.shape[3]
    dev = x.device
    off = offsets.permute(0, 2, 3, 1).reshape(n, ho, wo, deform_groups, 9, 2).to(F32)
    iy = torch.arange(ho, device=dev) * stride - 1
    ix = torch.arange(wo, device=dev) * stride - 1
    k = torch.arange(3, device=dev)
    by = (iy.view(ho, 1, 1, 1) + k.view(1, 1, 3, 1)).expand(ho, wo, 3, 3).reshape(1, ho, wo, 1, 9)
    bx = (ix.view(1, wo, 1, 1) + k.view(1, 1, 1, 3)).expand(ho, wo, 3, 3).reshape(1, ho, wo, 1, 9)
    ys = by.to(F32) + off[..., 0]
    xs = bx.to(F32) + off[..., 1]
    feat = x.permute(0, 2, 3, 1).reshape(n, h * w, cin)
    cdg = cin // deform_groups
    img = torch.arange(n, device=dev).view(n, 1)
    cols = []
    for g in range(deform_groups):
        y, xx = ys[..., g, :], xs[..., g, :]
        inside = (y > -1.0) & (y < h) & (xx > -1.0) & (xx < w)
        y0, x0 = torch.floor(y), torch.floor(xx)
        ly, lx = y - y0, xx - x0
        y0i, x0i = y0.long(), x0.long()
        col = 0
        for cy in (0, 1):
            for cx in (0, 1):
                yi, xi = y0i + cy, x0i + cx
                ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & inside
                wgt = torch.where(ok, (ly if cy else 1 - ly) * (lx if cx else 1 - lx),
                                  torch.zeros_like(ly))
                idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1)
                v = feat[:, :, g * cdg:(g + 1) * cdg][img, idx].reshape(
                    idx.shape[:1] + y.shape[1:] + (cdg,))
                col = col + v * wgt[..., None]
        cols.append(col)
    col = torch.cat(cols, -1).reshape(n, ho * wo, 9, groups, cin // groups)
    wg = weight.reshape(groups, cout // groups, cin // groups, 9).permute(3, 2, 0, 1)
    res = torch.einsum("npkgc,kcgo->npgo", prec.operand(col), prec.operand(wg))
    return prec.result(res).reshape(n, ho, wo, cout).permute(0, 3, 1, 2)
