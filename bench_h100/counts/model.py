"""HTD's operations per image, and the deformable convs' least times, from
the configuration and the bucket shape alone.

`layers(cfg, hw, rois, reg_rois)` lists every convolution and matrix
product of one image's forward as (name, operations, trainable); the
counts follow the published architecture (PGraph's graph products over
all R rois of the image; the level FC on each roi's own level only).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from bench_h100.counts import BF16_FLOP_PER_S, HBM_BYTES_PER_S

BLOCKS = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _out(s: int, k: int, stride: int, pad: int) -> int:
    return (s + 2 * pad - k) // stride + 1


def _conv(h, w, cin, cout, k, stride=1, groups=1):
    """(operations, out h, out w) of a k x k conv with padding (k - 1) // 2."""
    p = (k - 1) // 2
    ho, wo = _out(h, k, stride, p), _out(w, k, stride, p)
    return 2 * ho * wo * cout * (cin // groups) * k * k, ho, wo


def dcn_shapes(cfg: dict, hw: Sequence[int]) -> List[Tuple[int, int, int, int, int, int, int]]:
    """(h, w, cin, cout, stride, ho, wo) of each deformable conv at input hw."""
    bb = cfg["backbone"]
    h, w = _out(_out(hw[0], 7, 2, 3), 3, 2, 1), _out(_out(hw[1], 7, 2, 3), 3, 2, 1)
    out, planes = [], bb["base_planes"]
    for s, n in enumerate(BLOCKS[bb["depth"]]):
        width = planes if bb["groups"] == 1 else planes * bb["base_width"] * bb["groups"] // 64
        for i in range(n):
            stride = (1 if s == 0 else 2) if i == 0 else 1
            ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            if bb["stage_with_dcn"][s]:
                out.append((h, w, width, width, stride, ho, wo))
            h, w = ho, wo
        planes *= 2
    return out


def layers(cfg: dict, hw: Sequence[int], rois: int, reg_rois: int) -> List[Tuple[str, int, bool]]:
    bb = cfg["backbone"]
    frozen = bb["frozen_stages"]
    out: List[Tuple[str, int, bool]] = []
    ops, h, w = _conv(hw[0], hw[1], 3, bb["base_planes"], 7, 2)
    out.append(("stem", ops, False))
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, planes = bb["base_planes"], bb["base_planes"]
    c_sizes = []
    for s, n in enumerate(BLOCKS[bb["depth"]]):
        width = planes if bb["groups"] == 1 else planes * bb["base_width"] * bb["groups"] // 64
        cout = planes * 4
        train = s >= frozen
        for i in range(n):
            stride = (1 if s == 0 else 2) if i == 0 else 1
            o1, _, _ = _conv(h, w, cin, width, 1)
            o2, ho, wo = _conv(h, w, width, width, 3, stride, bb["groups"])
            o3, _, _ = _conv(ho, wo, width, cout, 1)
            tag = f"layer{s + 1}.{i}"
            out += [(tag + ".conv1", o1, train), (tag + ".conv2", o2, train),
                    (tag + ".conv3", o3, train)]
            if bb["stage_with_dcn"][s]:
                off, _, _ = _conv(h, w, width, 18 * bb["dcn_deform_groups"], 3, stride)
                out.append((tag + ".conv_offset", off, train))
            if i == 0:
                ds, _, _ = _conv(h, w, cin, cout, 1, stride)
                out.append((tag + ".downsample", ds, train))
            h, w, cin = ho, wo, cout
        c_sizes.append((h, w, cout))
        planes *= 2
    fo = cfg["fpn"]["out_channels"]
    levels = []
    for i, (lh, lw, ch) in enumerate(c_sizes):
        out.append((f"fpn.lateral{i}", _conv(lh, lw, ch, fo, 1)[0], True))
        out.append((f"fpn.out{i}", _conv(lh, lw, fo, fo, 3)[0], True))
        levels.append((lh, lw))
    for _ in range(cfg["fpn"]["num_outs"] - len(levels)):
        lh, lw = levels[-1]
        levels.append((_out(lh, 1, 2, 0), _out(lw, 1, 2, 0)))
    r = cfg["rpn"]
    na = len(r["anchor"]["ratios"]) * len(r["anchor"]["scales"])
    for i, (lh, lw) in enumerate(levels):
        out.append((f"rpn.conv{i}", _conv(lh, lw, r["in_channels"], r["feat_channels"], 3)[0],
                    True))
        out.append((f"rpn.heads{i}", _conv(lh, lw, r["feat_channels"], 5 * na, 1)[0], True))
    nc1 = cfg["num_classes"] + 1
    if cfg["with_global"]:
        g = cfg["global_ctx"]
        lh, lw = levels[-1]
        for i in range(g["num_convs"]):
            ci = g["in_channels"] if i == 0 else g["conv_out_channels"]
            out.append((f"global.conv{i}", _conv(lh, lw, ci, g["conv_out_channels"], 3)[0], True))
        out.append(("global.fc", 2 * g["conv_out_channels"] * nc1, True))
    h0, h1 = cfg["stage0_head"], cfg["stage1_head"]
    flat0 = h0["in_channels"] * h0["roi_feat_size"] ** 2
    f0 = h0["fc_out_channels"]
    out.append(("stage0.fcs", 2 * rois * (flat0 * f0 + f0 * f0 + f0 * (nc1 + 4)), True))
    flat1 = h1["in_channels"] * h1["roi_feat_size"] ** 2
    f1 = h1["fc_out_channels"]
    n_fcs = 2 if cfg["with_global"] else 1
    out.append(("stage1.fcs", 2 * rois * n_fcs * (flat1 * f1 + f1 * f1), True))
    out.append(("stage1.pgraph", 2 * rois * (f0 * nc1 + nc1 * (f0 + 1))
                + 2 * rois * rois * (f1 + (f0 + 1) + f1), True))
    out.append(("stage1.level_fc", 2 * rois * f1 * f1, True))
    out.append(("stage1.fc_cls", 2 * rois * f1 * nc1, True))
    o = h1["roi_feat_size"]
    convs = 0
    for i in range(h1["num_reg_convs"]):
        ci = h1["in_channels"] if i == 0 else h1["reg_mid_channels"]
        co = h1["reg_out_channels"] if i == h1["num_reg_convs"] - 1 else h1["reg_mid_channels"]
        convs += _conv(o, o, ci, co, 3)[0]
    out.append(("stage1.reg_convs", reg_rois * convs, True))
    out.append(("stage1.fc_reg", 2 * reg_rois * h1["reg_out_channels"] * 4, True))
    nl = len(cfg["roi_extractor"]["featmap_strides"])
    out.append(("ba.attention", 2 * nl * reg_rois * (fo * 128 + 128), True))
    return out


def infer_flops(cfg: dict, hw: Sequence[int]) -> int:
    """Operations of one test image in bucket hw: nms_post proposals in both
    stages, the BA regression on all of them."""
    n = cfg["proposal_test"]["nms_post"]
    return sum(ops for _, ops, _ in layers(cfg, hw, n, n))


def train_flops(cfg: dict, hw: Sequence[int]) -> int:
    """Operations of one training image in bucket hw: the sampler's rois per
    stage, the BA regression on the positive block; trainable layers three
    times their forward, frozen ones once."""
    t = cfg["train"]
    n = max(s["sampler"]["num"] for s in t["rcnn"])
    return sum(ops * (3 if train else 1)
               for _, ops, train in layers(cfg, hw, n, t["rcnn_pos_cap"]))


def _least_s(ops: float, nbytes: float) -> float:
    return max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def dcn_fwd_least_s(cfg: dict, hw: Sequence[int], images: int = 1) -> float:
    """The least time of every deformable conv forward of `images` images
    in bucket hw, each conv bounded apart: 2 * Ho * Wo * 9 * Cin / g * Cout
    operations at the bf16 peak, or its bytes (input, offsets, weight read
    once, output written once, 2 bytes each) at HBM speed."""
    g = cfg["backbone"]["groups"]
    dg = cfg["backbone"]["dcn_deform_groups"]
    total = 0.0
    for h, w, cin, cout, _, ho, wo in dcn_shapes(cfg, hw):
        ops = 2 * images * ho * wo * 9 * cin // g * cout
        nbytes = 2 * (images * (h * w * cin + ho * wo * 18 * dg + ho * wo * cout)
                      + 9 * cin // g * cout)
        total += _least_s(ops, nbytes)
    return total


def dcn_bwd_least_s(cfg: dict, hw: Sequence[int], images: int) -> float:
    """The least time of every deformable conv backward (d_x, d_offsets,
    d_weight) of `images` images in bucket hw: the input's and the
    weight's products (2 * Ho * Wo * 9 * Cin / g * Cout each) and the
    offsets' (2 * 2 * Ho * Wo * 9 * Cin) at the bf16 peak, or the bytes of
    g, x, offsets and weight read and d_x, d_offsets and d_weight written,
    2 bytes each."""
    g = cfg["backbone"]["groups"]
    dg = cfg["backbone"]["dcn_deform_groups"]
    total = 0.0
    for h, w, cin, cout, _, ho, wo in dcn_shapes(cfg, hw):
        p = images * ho * wo
        ops = 2 * 2 * p * 9 * cin // g * cout + 2 * 2 * p * 9 * cin
        nbytes = 2 * (p * cout + 2 * images * h * w * cin + 2 * p * 18 * dg
                      + 2 * 9 * cin // g * cout)
        total += _least_s(ops, nbytes)
    return total
