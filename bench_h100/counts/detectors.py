"""DetectoRS R-50 under HTD's heads: operations per image and the least
time of its switchable atrous convs' deformable convs, from the
configuration and the bucket shape alone (the conventions of
`counts/__init__.py`).

`layers` is `counts.model.layers` (HTD R-50: the first backbone with one
3x3 product per conv2, the FPN, the RPN, the heads) and what DetectoRS
adds to it: each SAC conv's second product (dilation 3), its two offset
convs, its switch and its two contexts; each further backbone of the
recursive feature pyramid (its convs, its SAC convs, its `rfp_conv`s) and
the FPN run again on it; ASPP on P3, P4 and P5 (ASPP(P6), which nothing
reads, is not counted); the gate's 1x1 conv on every level.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from bench_h100.counts.model import BLOCKS, _conv, _least_s, _out, dcn_shapes
from bench_h100.counts.model import layers as htd_layers
from bench_h100.reference.detectors import ASPP_DILATIONS, ASPP_OUT


def sac_shapes(cfg: dict, hw: Sequence[int]) -> List[Tuple[int, int, int, int, int, int, int]]:
    """(h, w, cin, cout, stride, ho, wo) of each SAC conv of one backbone:
    `dcn_shapes` with deformable convs where SAC is."""
    bb = cfg["backbone"]
    return dcn_shapes(dict(cfg, backbone=dict(bb, stage_with_dcn=bb["stage_with_sac"])), hw)


def _added(cfg: dict, hw: Sequence[int], fed: int) -> List[Tuple[str, int, bool]]:
    """What DetectoRS adds to one backbone's ResNet convs: each SAC conv's
    second product, offset convs, switch and contexts, and the `rfp_conv`s
    (`fed` input channels; 0: none)."""
    bb = cfg["backbone"]
    out = []
    h, w = _out(_out(hw[0], 7, 2, 3), 3, 2, 1), _out(_out(hw[1], 7, 2, 3), 3, 2, 1)
    planes = bb["base_planes"]
    for s, n in enumerate(BLOCKS[bb["depth"]]):
        for i in range(n):
            stride = (1 if s == 0 else 2) if i == 0 else 1
            ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            p = f"layer{s + 1}.{i}"
            if bb["stage_with_sac"][s]:
                c = planes
                out += [(p + ".conv2_dil3", 2 * ho * wo * 9 * c * c, False),
                        (p + ".offsets", 2 * _conv(h, w, c, 18, 3, stride)[0], False),
                        (p + ".switch", 2 * ho * wo * c, False),
                        (p + ".contexts", 2 * 2 * c * c, False)]
            if fed and s and not i:
                out.append((p + ".rfp_conv", 2 * ho * wo * fed * planes * 4, False))
            h, w = ho, wo
        planes *= 2
    return out


def _levels(cfg: dict, hw: Sequence[int]) -> List[Tuple[int, int]]:
    """(h, w) of P2..P5 and of the max-pooled levels above them."""
    h, w = _out(_out(hw[0], 7, 2, 3), 3, 2, 1), _out(_out(hw[1], 7, 2, 3), 3, 2, 1)
    out = [(h, w)]
    for _ in range(3):
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        out.append((h, w))
    for _ in range(cfg["fpn"]["num_outs"] - 4):
        h, w = _out(h, 1, 2, 0), _out(w, 1, 2, 0)
        out.append((h, w))
    return out


def layers(cfg: dict, hw: Sequence[int], rois: int, reg_rois: int) -> List[Tuple[str, int, bool]]:
    fpn = cfg["fpn"]
    out = htd_layers(cfg, hw, rois, reg_rois) + _added(cfg, hw, 0)
    again = [(name, ops, t) for name, ops, t in out
             if name == "stem" or name.startswith(("layer", "fpn."))]
    fed = len(ASPP_DILATIONS) * ASPP_OUT
    fo, a = fpn["out_channels"], ASPP_OUT
    levels = _levels(cfg, hw)
    for k in range(fpn["rfp_steps"] - 1):
        tag = f"rfp{k}."
        out += [(tag + name, ops, t) for name, ops, t in again]
        out += [(tag + name, ops, t) for name, ops, t in _added(cfg, hw, fed)
                if name.endswith(".rfp_conv")]
        for lvl in (1, 2, 3):
            lh, lw = levels[lvl]
            for i, d in enumerate(ASPP_DILATIONS):
                pix = 1 if i == len(ASPP_DILATIONS) - 1 else lh * lw
                kk = 3 if d > 1 else 1
                out.append((f"{tag}aspp{lvl}.{i}", 2 * pix * kk * kk * fo * a, False))
        out += [(f"{tag}gate{lvl}", 2 * lh * lw * fo, False) for lvl, (lh, lw) in enumerate(levels)]
    return out


def infer_flops(cfg: dict, hw: Sequence[int]) -> int:
    """Operations of one test image in bucket hw: nms_post proposals in both
    stages, the BA regression on all of them."""
    n = cfg["proposal_test"]["nms_post"]
    return sum(ops for _, ops, _ in layers(cfg, hw, n, n))


def sac_fwd_least_s(cfg: dict, hw: Sequence[int], images: int = 1) -> float:
    """The least time of every deformable conv of every SAC conv (two each,
    at dilation 1 and 3, in each of the `rfp_steps` backbones) of `images`
    images in bucket hw, each bounded apart as `model.dcn_fwd_least_s`
    bounds a DCN: 2 * Ho * Wo * 9 * Cin * Cout operations at the bf16 peak,
    or its bytes (input, 18 offsets, weight read once, output written once,
    2 bytes each) at HBM speed."""
    total = 0.0
    for h, w, cin, cout, _, ho, wo in sac_shapes(cfg, hw):
        ops = 2 * images * ho * wo * 9 * cin * cout
        nbytes = 2 * (images * (h * w * cin + ho * wo * 18 + ho * wo * cout) + 9 * cin * cout)
        total += _least_s(ops, nbytes)
    return 2 * cfg["fpn"]["rfp_steps"] * total
