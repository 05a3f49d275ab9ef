"""The third configuration, `htd_x101_dcn_2x` (X-101-64x4d-DCN), and its cell
`x101dcn.infer`, on the CPU: the reference against the program at the
tiny configuration, the frozen counts with 64 weight groups, the readers of
the `htd.dcn` spans (`dcn.device_ms`, `dcn.host_ms`) over a hand-made
trace, the manifest's entries, and the cell's limits against the fp8
control and the planted faults."""

import json
import math

import pytest

from bench_h100 import faults, harness
from bench_h100.counts import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from bench_h100.counts import model as M
from bench_h100.tests.tiny import tiny_doc
from bench_h100.trace import Trace

CONFIG, CELL = "htd_x101_dcn_2x", "x101dcn.infer"
NEW = ("dcn.device_ms", "dcn.host_ms")


def read(name, tr, info=None):
    return harness.load_module("metrics", name).read(tr, info or {})


# -- the reference and the counts ------------------------------------------------


@pytest.mark.parametrize("hw", [(120, 160), (160, 90)])
def test_detections_match_the_program(hw):
    from bench_h100.tests.test_bench_reference import test_detections_match_the_program as check

    check(CONFIG, hw)


def test_the_file_holds_to_its_preset_uncut():
    doc = json.loads((harness.BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg = harness.port_config(doc)
    assert doc["reduced"] == [] and cfg.backbone.depth == 101
    assert (cfg.backbone.groups, cfg.backbone.base_width) == (64, 4)
    assert tuple(cfg.test_scale) == (1600, 800) and cfg.rcnn_test.use_soft_nms
    assert len(doc["assumed"]["offset_weight_std"]) == 30


def test_grouped_dcn_least_time_by_hand():
    cfg = tiny_doc(CONFIG)["config"]
    shapes = M.dcn_shapes(cfg, (96, 160))
    assert [s[2] for s in shapes] == [512, 1024, 2048]     # layer2-4 at depth 10, 64x4d
    want = 0.0
    for h, w, cin, cout, stride, ho, wo in shapes:
        ops = 2 * ho * wo * 9 * (cin // 64) * cout
        nbytes = 2 * (h * w * cin + ho * wo * 18 + ho * wo * cout + 9 * (cin // 64) * cout)
        want += max(ops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
    assert math.isclose(M.dcn_fwd_least_s(cfg, (96, 160)), want, rel_tol=1e-12)


def test_published_x101_counts_at_both_buckets():
    """2,444 GFLOP an image and 236 us of least K3 time at 800x1600,
    the same at 1600x800; the grouped 3x3 convs count Cin / 64 a group."""
    cfg = json.loads((harness.BENCH / "configs" / f"{CONFIG}.json").read_text())["config"]
    for hw in ((800, 1600), (1600, 800)):
        assert 2443 < M.infer_flops(cfg, hw) / 1e9 < 2444.5
        assert 236.0 < M.dcn_fwd_least_s(cfg, hw) * 1e6 < 236.2
    convs = dict((n, o) for n, o, _ in M.layers(cfg, (800, 1600), 1000, 1000))
    # layer1's grouped 3x3: 200 x 400 pixels, 256 channels of 4 inputs each
    assert convs["layer1.0.conv2"] == 2 * 200 * 400 * 256 * 4 * 9


def test_dcn_roofline_reads_the_grouped_path():
    cfg = tiny_doc(CONFIG)["config"]
    tr = dcn_trace()
    info = {"config": cfg, "unit_buckets": [(96, 160)] * 2}
    ms = (15 + 5 + 12) / 2 / 1e6
    assert read("dcn_fwd_roofline", tr, info) == pytest.approx(
        100.0 * M.dcn_fwd_least_s(cfg, (96, 160)) * 1e3 / ms)


# -- the readers of the htd.dcn spans ------------------------------------------------


def dcn_trace():
    # two requests; the first has two htd.dcn spans inside its backbone
    # (each an offset conv and a K3 kernel, one K3 running past its span's
    # end), the second one; an op launched in the backbone outside any
    # htd.dcn span, and one with no launch call
    units = [(0, 100), (100, 200)]
    spans = [("htd.backbone_fpn", 10, 60), ("htd.dcn", 12, 20), ("htd.dcn", 30, 38),
             ("htd.post", 70, 90), ("htd.backbone_fpn", 110, 160), ("htd.dcn", 120, 135)]
    device = [("conv_offset", 14, 18, 13), ("deform_conv_fwd_kernel", 18, 33, 16),
              ("conv", 40, 50, 25), ("conv_offset", 36, 40, 31),
              ("deform_conv_fwd_kernel", 40, 45, 33), ("nms", 75, 80, 72),
              ("conv_offset", 122, 125, 121), ("deform_conv_fwd_kernel", 125, 137, 130),
              ("lost_launch", 140, 150, None)]
    return Trace(units, spans, device, 0, 0, 200)


def test_dcn_device_ms_takes_the_ops_launched_in_its_spans():
    # request 1: 4 + 15 + 4 + 5; request 2: 3 + 12; the conv launched at
    # 25 lies in the backbone between the two spans
    assert read("dcn.device_ms", dcn_trace()) == pytest.approx((28 + 15) / 2 / 1e6)


def test_dcn_host_ms_is_the_spans_union():
    assert read("dcn.host_ms", dcn_trace()) == pytest.approx((8 + 8 + 15) / 2 / 1e6)


def test_the_nested_span_leaves_the_layer_readers_as_they_were():
    tr = dcn_trace()
    plain = tr._replace(spans=[s for s in tr.spans if s[0] != "htd.dcn"])
    for name in ("backbone_fpn.device_ms", "entry.host_ms", "post.host_ms",
                 "device.idle_pct.infer", "launches.per_request"):
        assert read(name, tr) == read(name, plain), name


def test_no_dcn_span_reads_none():
    tr = dcn_trace()
    parent = tr._replace(spans=[s for s in tr.spans if s[0] != "htd.dcn"])
    for name in NEW:
        assert read(name, parent) is None, name
        assert read(name, tr._replace(units=[])) is None, name


# -- the manifest --------------------------------------------------------------------


def manifest():
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_the_cell_reports_what_r101dcn_reports_and_the_dcn_metrics():
    m = manifest()
    harness.check_manifest(m)
    cell = next(w for w in m["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "closed_loop_640x480", 1)
    assert len(cell["why"]) <= 200
    assert [e["name"] for e in m["per_layer"][-len(NEW):]] == list(NEW)
    for e in m["per_layer"][-len(NEW):]:
        assert e["workloads"] == ["r101dcn.infer", CELL] and e["layer"] == "backbone and FPN"
        assert (harness.BENCH / "metrics" / f"{e['name']}.py").exists()
    x101 = harness.load_cell(CELL)
    r101 = harness.load_cell("r101dcn.infer")
    assert [e["name"] for e in x101.end_to_end] == [e["name"] for e in r101.end_to_end]
    assert [e["name"] for e in x101.per_layer] == [e["name"] for e in r101.per_layer]
    assert "dcn_fwd_roofline" in {e["name"] for e in x101.per_layer}
    assert not set(NEW) & {e["name"] for e in harness.load_cell("r50.infer").per_layer}


# -- correct ---------------------------------------------------------------------------


def test_sound_x101_is_correct():
    from bench_h100.tests.test_bench_faults import outcome, tiny_cell

    res = outcome(tiny_cell(CELL, CONFIG), trace=True)
    assert res["correct"], res["compared"]
    # the CPU's trace holds host spans and no device op
    assert "dcn.host_ms" in res["metrics"] and "dcn.device_ms" not in res["metrics"]


@pytest.mark.parametrize("fault", [faults.top_half, faults.shifted_boxes, faults.relabelled_fifth],
                         ids=lambda f: f.__name__)
def test_broken_x101_is_not_correct(fault):
    from bench_h100.tests.test_bench_faults import outcome, tiny_cell

    assert not outcome(tiny_cell(CELL, CONFIG), program=fault)["correct"]


def test_fp8_control_fails_and_float32_passes():
    from bench_h100.reference.judge import detection_numbers, held
    from bench_h100.tests.test_bench_control import control
    from bench_h100.tests.test_bench_faults import tiny_cell

    cell = tiny_cell(CELL, CONFIG, check_requests=4)
    sides = control().control_pairs(cell, 2**31 + 3, "cpu", ("fp8", "float32"))
    fp8 = detection_numbers(sides["fp8"])
    f32 = detection_numbers(sides["float32"])
    assert not held(fp8, cell.limits["numbers"])[0], fp8
    assert held(f32, cell.limits["numbers"])[0], f32
