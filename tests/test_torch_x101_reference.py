"""X-101-64x4d-DCN against the benchmark's plain reference on the CPU.

The port (`htd_tpu_torch`) and `bench_h100/reference/` (float32 PyTorch,
no kernel, written apart from the port) run one image each from the same
seeded state dict: a tiny X-101 with the published layer kinds (64 weight
groups of 4 channels at the base width, so every stage at its full width;
deformable conv2 in layer2-4; soft-NMS), at depth 10 and test scale
160x96. Both orientations take their own bucket. The detections must
agree as the R-50 and R-101-DCN ones do, by the same comparison
(`bench_h100/tests/test_bench_reference.py`).

This file imports neither JAX nor the JAX package.
"""

import pytest
import torch

import bench_h100.tests.test_bench_reference as bench_ref
from bench_h100.reference.detector import dcn_convs
from bench_h100.tests.tiny import tiny_doc

torch.set_num_threads(1)
CONFIG = "htd_x101_dcn_2x"


def test_tiny_x101_is_grouped_and_deformable():
    """The tiny configuration keeps what X-101-64x4d-DCN forces: 64 groups
    of 4 channels at layer1's width 256, grouped DCN in layer2-4 with one
    deform group, and soft-NMS, in the program and the reference alike."""
    model, ref = bench_ref.pair(CONFIG)
    bb = model.cfg.backbone
    assert (bb.groups, bb.base_width, bb.dcn_deform_groups) == (64, 4, 1)
    assert bb.stage_with_dcn == (False, True, True, True) and model.cfg.rcnn_test.use_soft_nms
    assert model.backbone.layer1[0].conv2.groups == 64
    assert model.backbone.layer1[0].conv2.weight.shape == (256, 4, 3, 3)
    convs = dcn_convs(tiny_doc(CONFIG)["config"])
    assert [(name, cin) for name, cin, _, _ in convs] == [
        ("backbone.layer2.0.conv2", 512), ("backbone.layer3.0.conv2", 1024),
        ("backbone.layer4.0.conv2", 2048)]
    for name, cin, stride, _ in convs:
        m = model.get_submodule(name)
        assert (m.groups, m.stride, m.weight.shape[1]) == (64, stride, cin // 64)
        assert ref.sd[name + ".weight"].shape == m.weight.shape


@pytest.mark.parametrize("hw", [(120, 160), (160, 90)], ids=["landscape", "portrait"])
def test_x101_detections_match_the_reference(hw):
    bench_ref.test_detections_match_the_program(CONFIG, hw)
