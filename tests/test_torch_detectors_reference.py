"""DetectoRS R-50 under HTD's heads against the benchmark's plain reference
on the CPU.

The port (`htd_tpu_torch`) and `bench_h100/reference/detectors.py`
(float32 PyTorch, no kernel, written apart from the port) run from the same
seeded state dict (`bench_h100/weights_rfp.py`): each piece (ConvAWS, SAC
at stride 1 and 2, ASPP, the recursive feature pyramid's fused levels),
then whole images in both orientations, compared as the other
configurations' detections are (`bench_h100/tests/test_bench_reference.py`).
The tiny configuration is the published one at depth 10 (one block a
stage, so three SAC convs a backbone) and test scale 160x96, with its
offset and switch stds read from the reference at that size as
`bench_h100/calibrate_rfp.py` reads them at the published one.

This file imports neither JAX nor the JAX package.
"""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.counts import detectors as counts
from bench_h100.harness import port_config
from bench_h100.program import build_detector
from bench_h100.reference import ops as rops
from bench_h100.reference.detectors import (DetectorsReference, deform_conv, param_shapes,
                                            sac_convs)
from bench_h100.tests.tiny import tiny_doc
from bench_h100.weights_rfp import make_state_dict
from htd_tpu_torch import config as C
from htd_tpu_torch.models.detector import HTDDetector
from htd_tpu_torch.models.fpn import ASPP
from htd_tpu_torch.models.layers import ConvAWS2d
from htd_tpu_torch.models.resnet import SAConv2d
from htd_tpu_torch.ops.dcn import deform_conv2d_plain

torch.set_num_threads(1)
CONFIG = "htd_detectors_r50_1x"
SEED = 2**31 + 23


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def tiny(seed: int = SEED, **assumed):
    """The tiny configuration file's dict, with the offset and switch stds
    read from the float32 reference at its own size (about 2 px of offset,
    the switch spread about 0.25 around 0.5) and `assumed` changed."""
    doc = tiny_doc(CONFIG)
    doc["assumed"].update(score_scale=30.0, **assumed)     # detections from a depth-10 net
    convs = sac_convs(doc["config"])
    zero = dict(doc["assumed"], offset_weight_std=[0.0] * len(convs),
                switch_weight_std=[0.0] * len(convs))
    ref = DetectorsReference(doc["config"], make_state_dict(doc["config"], zero, seed, "cpu"))
    img = np.random.default_rng(seed).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    rms = ref.sac_input_rms(img)
    a = doc["assumed"]
    a["offset_weight_std"] = [a["offset_px"] / (math.sqrt(9 * c) * r)
                              for (_, c, _), r in zip(convs, rms)]
    a["switch_weight_std"] = [a["switch_spread"] / (math.sqrt(c) * r)
                              for (_, c, _), r in zip(convs, rms)]
    return doc


@pytest.fixture(scope="module")
def pair():
    """The port and the reference over one seeded state dict, float32."""
    doc = tiny()
    sd = make_state_dict(doc["config"], doc["assumed"], SEED, "cpu")
    model = build_detector(port_config(doc), dict(sd), "cpu")
    return model, DetectorsReference(doc["config"], sd), doc


def test_tiny_configuration_keeps_what_detectors_forces(pair):
    """Depth 10 keeps every kind of layer: ConvAWS everywhere, a deformable
    SAC conv2 in layer2-4 of both backbones, an rfp_conv on block 0 of
    layer2-4 of the second, ASPP and the gate; hard NMS and R-50's widths."""
    model, ref, doc = pair
    cfg = model.cfg
    assert cfg.backbone.conv_aws
    assert cfg.backbone.stage_with_sac == (False, True, True, True)
    assert cfg.fpn.rfp_steps == 2 and not cfg.rcnn_test.use_soft_nms
    assert [n for n, _, _ in sac_convs(doc["config"])] == [
        f"{p}.layer{s}.0.conv2" for p in ("backbone", "neck.rfp_modules.0") for s in (2, 3, 4)]
    for name, c, stride in sac_convs(doc["config"]):
        m = model.get_submodule(name)
        assert isinstance(m, SAConv2d) and m.stride == (stride, stride)
        assert m.weight.shape == (c, c, 3, 3)
    for s, cout in ((2, 512), (3, 1024), (4, 2048)):
        assert model.get_submodule(f"neck.rfp_modules.0.layer{s}.0.rfp_conv").weight.shape == \
            (cout, 256, 1, 1)
        assert model.get_submodule(f"backbone.layer{s}.0").rfp_conv is None
    assert isinstance(model.backbone.conv1, ConvAWS2d)
    # the offsets read from the reference give 2 px where `offset_px` says
    assert all(0.0 < s < 1.0 for s in doc["assumed"]["offset_weight_std"])


def test_state_dict_names_are_mmdets():
    """The preset at its published depth holds exactly the reference's
    tensors, under mmdet's names (DetectoRS_ResNet, RFP, SAConv2d,
    ConvAWS2d), with the reference's shapes."""
    with torch.device("meta"):
        model = HTDDetector(C.htd_detectors_r50_1x())
    cfg = tiny_doc(CONFIG)["config"]
    cfg["backbone"]["depth"] = 50
    shapes = param_shapes(cfg)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: s for k, (s, _) in shapes.items()}
    for name in ("backbone.conv1.weight_gamma", "backbone.layer1.0.conv2.weight_beta",
                 "backbone.layer2.0.conv2.weight_diff", "backbone.layer3.5.conv2.switch.bias",
                 "backbone.layer4.2.conv2.pre_context.weight",
                 "neck.rfp_modules.0.layer2.0.conv2.offset_l.weight",
                 "neck.rfp_modules.0.layer4.0.rfp_conv.bias",
                 "neck.rfp_modules.0.layer4.0.downsample.0.weight_gamma",
                 "neck.rfp_aspp.aspp.3.weight", "neck.rfp_weight.bias",
                 "neck.lateral_convs.0.conv.weight", "neck.fpn_convs.3.conv.bias"):
        assert name in got, name
    assert len(sac_convs(cfg)) == 26


def test_conv_aws_matches_the_reference():
    """ConvAWS2d against the reference's standardised weight: the same
    float32 formula and the same convolution, so within 1e-5 of the largest
    output (summation order). The kept weight is reused by calls without
    autograd, derived afresh by a call with it, and derived again after
    `load_state_dict`."""
    g = torch.Generator().manual_seed(1)
    m = ConvAWS2d(16, 24, 3, padding=1, bias=False)
    sd = {"c.weight": torch.randn(24, 16, 3, 3, generator=g),
          "c.weight_gamma": torch.rand(24, 1, 1, 1, generator=g) + 0.5,
          "c.weight_beta": torch.randn(24, 1, 1, 1, generator=g) * 0.1}
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    ref = DetectorsReference(tiny_doc(CONFIG)["config"], sd)
    x = torch.randn(2, 16, 11, 13, generator=g)
    with torch.no_grad():
        got = m(x)
        kept = m.weights()
        assert m.weights() is kept
        want = rops.conv2d(x, ref.aws_weight("c"), None, ref.prec, 1, 1)
        assert rel_err(got, want) <= 1e-5
    with torch.enable_grad():
        assert m.weights() is not kept and m.weights().requires_grad
    sd["c.weight"] = sd["c.weight"] * 2.0 + 1.0
    m.load_state_dict({"weight": sd["c.weight"]}, strict=False)
    with torch.no_grad():
        assert m.weights() is not kept
        assert rel_err(m(x), rops.conv2d(x, ref.aws_weight("c"), None, ref.prec, 1, 1)) <= 1e-5


def _sac_pair(stride, seed=2, c=64):
    """A SAConv2d and the reference over one random state dict whose every
    tensor counts: offsets of about 2 px, the switch about 0.5 +- 0.25."""
    g = torch.Generator().manual_seed(seed)
    m = SAConv2d(c, c, stride)
    sd = {}
    for k, v in m.state_dict().items():
        scale = {"weight": 0.05, "weight_diff": 0.02, "weight_gamma": 0.05, "switch.weight": 0.05,
                 "switch.bias": 0.0, "offset_s.weight": 0.15, "offset_l.weight": 0.15}.get(k, 0.1)
        sd[k] = torch.randn(v.shape, generator=g) * scale
    sd["weight_gamma"] = sd["weight_gamma"].abs() + 0.02
    sd["switch.bias"] = torch.full((1,), 0.5)
    m.load_state_dict(sd)
    cfg = tiny_doc(CONFIG)["config"]
    return m, DetectorsReference(cfg, {"c." + k: v for k, v in sd.items()}), g


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_sac_matches_the_reference(stride, batch):
    """SAConv2d against the reference's SAC, float32, on one image and on
    two (whose contexts are each image's own means): within 1e-4 of the
    largest output. Both take the same samples (the offsets are added to
    the same integer grid in float32) and sum in float32 in other orders
    (the port's K3 plain version per tap and channel, the reference's one
    einsum; the blend as a lerp against the reference's two products), so
    they differ by a few float32 roundings of partial sums."""
    m, ref, g = _sac_pair(stride)
    x = torch.relu(torch.randn(batch, 64, 21, 30, generator=g))
    with torch.no_grad():
        got = m(x)
        want = ref.sac(x, "c", stride)
        for i in range(batch):          # each image's result is its own
            assert rel_err(m(x[i:i + 1])[0], want[i]) <= 1e-4
    assert got.shape == want.shape == (batch, 64, (21 - 1) // stride + 1,
                                       (30 - 1) // stride + 1)
    assert rel_err(got, want) <= 1e-4
    off = m.offset_l(torch.nn.functional.avg_pool2d(   # the offsets move samples by pixels
        torch.nn.functional.pad(x, (2, 2, 2, 2), mode="reflect"), 5, 1))
    assert off.abs().mean() > 0.5


def test_aspp_matches_the_reference():
    """ASPP, 32 -> 4 x 64 channels at dilations (1, 3, 6, 1): the same float32
    convolutions, within 1e-5 of the largest output."""
    g = torch.Generator().manual_seed(3)
    m = ASPP(32)
    sd = {k: torch.randn(v.shape, generator=g) * 0.1 for k, v in m.state_dict().items()}
    m.load_state_dict(sd)
    ref = DetectorsReference(tiny_doc(CONFIG)["config"],
                             {"neck.rfp_aspp." + k: v for k, v in sd.items()})
    x = torch.randn(1, 32, 17, 23, generator=g)
    with torch.no_grad():
        got, want = m(x), ref.aspp(x)
    assert got.shape == want.shape == (1, 256, 17, 23)
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("hw", [(96, 160), (160, 96)], ids=["landscape", "portrait"])
def test_rfp_levels_match_the_reference(pair, hw):
    """The fused pyramid (both backbones, ASPP, the shared FPN run twice,
    the gate) on a normalised bucket, float32: every level within 1e-4 of
    its largest value (float32 sums in other orders through two ResNets;
    the gate blended as a lerp)."""
    model, ref, _ = pair
    img = torch.from_numpy(np.random.default_rng(hw[0]).normal(0, 1, hw + (3,))
                           .astype(np.float32))
    with torch.no_grad():
        got = model._features(img[None])
        want = ref.features(img)
    assert len(got) == len(want) == 5
    for lvl, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and rel_err(a, b) <= 1e-4, lvl


@pytest.mark.parametrize("hw", [(120, 160), (160, 90)], ids=["landscape", "portrait"])
def test_detections_match_the_reference(pair, hw):
    """`inference_detector` against the reference's detections, as
    `bench_h100/tests/test_bench_reference.py` compares the other
    configurations: the same labels, boxes within 1e-3 px, scores within
    1e-5, and the relaxed set beginning with the strict one."""
    from htd_tpu_torch.apis import inference_detector

    model, ref, _ = pair
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    pb, ps, pl = inference_detector(model, img)
    (sb, ss, sl), (rb, rs, rl) = ref.detect(img)
    assert len(pb) == len(sb) > 0
    np.testing.assert_array_equal(pl, sl)
    np.testing.assert_allclose(pb, sb, atol=1e-3)
    np.testing.assert_allclose(ps, ss, atol=1e-5)
    np.testing.assert_array_equal(rl[:len(sl)], sl)
    assert len(rb) >= len(sb)


@pytest.mark.parametrize("path", ["weight_diff", "rfp_conv", "context", "offset", "switch",
                                  "rfp_weight", "weight_beta"])
def test_each_assumed_path_moves_the_reference(pair, path):
    """`assumed` draws each path that mmdet's init starts at zero (or at a
    constant) so that it counts: zeroing it (the switch: its weight) moves
    the reference's fused pyramid by over 1% of its largest value on some
    level."""
    _, ref, doc = pair
    img = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (96, 160, 3))
                           .astype(np.float32))
    suffix = {"weight_diff": (".weight_diff",), "rfp_conv": (".rfp_conv.weight",),
              "context": (".pre_context.weight", ".post_context.weight"),
              "offset": (".offset_s.weight", ".offset_l.weight"),
              "switch": (".switch.weight",), "rfp_weight": ("rfp_weight.weight",),
              "weight_beta": (".weight_beta",)}[path]
    cut = {k: torch.zeros_like(v) if k.endswith(suffix) else v for k, v in ref.sd.items()}
    assert sum(k.endswith(suffix) for k in ref.sd) > 0
    with torch.no_grad():
        base = ref.features(img)
        moved = DetectorsReference(doc["config"], cut).features(img)
    assert max(rel_err(a, b) for a, b in zip(moved, base)) > 0.01


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_k3_at_dilation_3_is_the_references(stride):
    """K3's plain version (`deform_conv2d_plain`) at dilation 3 (padding 3)
    against the reference's dilated DCNv1 on samples some of which fall
    outside the map: the same float32 sample positions and corner weights,
    sums in other orders, within 1e-5 of the largest output."""
    g = torch.Generator().manual_seed(11 + stride)
    x = torch.randn(2, 64, 19, 26, generator=g)
    ho, wo = (19 - 1) // stride + 1, (26 - 1) // stride + 1
    off = torch.randn(2, 18, ho, wo, generator=g) * 3.0
    w = torch.randn(48, 64, 3, 3, generator=g) * 0.05
    ref = DetectorsReference(tiny_doc(CONFIG)["config"], {})
    want = deform_conv(x, off, w, stride, 3, ref.prec)
    got = deform_conv2d_plain(x.permute(0, 2, 3, 1).contiguous(),
                              off.permute(0, 2, 3, 1).contiguous(),
                              w.permute(2, 3, 1, 0).contiguous(), stride, 3)
    assert rel_err(got.permute(0, 3, 1, 2), want) <= 1e-5
    # dilation 3 is another function than dilation 1 on the same inputs
    one = deform_conv(x, off, w, stride, 1, ref.prec)
    assert rel_err(one, want) > 0.1


def test_counts_are_the_references_products(pair):
    """The frozen operations of the backbones and the neck
    (`counts/detectors.layers`, all but the RPN and the heads) are the
    convolutions and products the reference's `features` runs, as
    `torch.utils.flop_counter` counts them, at the tiny configuration."""
    _, ref, doc = pair
    hw = (96, 160)
    img = torch.zeros(hw + (3,))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.features(img)
    layers = counts.layers(doc["config"], hw, 0, 0)
    front = sum(o for n, o, _ in layers
                if not n.split(".")[0] in ("rpn", "global", "stage0", "stage1", "ba"))
    assert front == fc.get_total_flops()
    sac = 2 * sum(2 * ho * wo * 9 * ci * co for _, _, ci, co, _, ho, wo in
                  counts.sac_shapes(doc["config"], hw))
    assert counts.sac_fwd_least_s(doc["config"], hw) >= sac / 989e12


def test_the_preset_does_not_train(pair):
    """Training is not ported for DetectoRS: `forward_train` raises, naming
    the preset."""
    model, _, _ = pair
    with pytest.raises(NotImplementedError, match="htd_detectors_r50_1x"):
        model.forward_train(torch.zeros(1, 96, 160, 3), torch.tensor([[96.0, 160.0]]),
                            torch.zeros(1, 1, 4), torch.zeros(1, 1), torch.zeros(1, 1))


@pytest.mark.parametrize("fault", [None, "top_half", "shifted_boxes"])
def test_the_cell_judges_the_program(fault):
    """`detectors_r50.infer`'s generator (`closed_loop_infer_rfp`) on the CPU
    at the tiny configuration, judged by the cell's own limits as
    `bench_h100/run.py` judges it: the sound program is correct, and the
    timed path broken underneath (`bench_h100/faults.py`) is not."""
    import time

    from bench_h100 import faults, harness
    from bench_h100.reference.judge import held

    real = harness.load_cell("detectors_r50.infer")
    tp = dict(real.traffic, pool=6, sizes=[[120, 160], [160, 120]], trace_units=2,
              check_requests=3)
    cell = harness.Cell(real.name, 1, tiny(), tp, real.limits, real.end_to_end, real.per_layer)
    ctx = harness.Context(cell, 2**31 + 11, 0.5, False, time.perf_counter(), device="cpu",
                          program=fault and getattr(faults, fault))
    out = harness.load_module("generators", tp["generator"]).run(ctx)
    ok, rows = held(out.numbers, cell.limits["numbers"], out.failed)
    assert out.failed == 0 and out.attempted > 0
    assert ok is (fault is None), rows
