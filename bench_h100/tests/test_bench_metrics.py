"""The metric arithmetic: window statistics, interval unions, self time,
the readers over a hand-made trace, mfu, and the manifest's naming rules."""

import copy
import json

import numpy as np
import pytest

from bench_h100 import harness
from bench_h100.counts import BF16_FLOP_PER_S
from bench_h100.counts.model import infer_flops
from bench_h100.stats import window_stats
from bench_h100.tests.tiny import tiny_doc
from bench_h100.trace import Trace, busy_ns, gaps, self_time, union_length


def test_window_stats_p95_and_rate():
    lat = [0.010 + 0.001 * i for i in range(100)]          # 10 .. 109 ms
    st = window_stats(lat, 4.0)
    assert st["p95"] == pytest.approx(105.0)                # a sample: the 96th of 100
    assert st["p50"] == pytest.approx(60.0)
    assert st["rate"] == 25.0 and st["done"] == 100


def test_window_stats_failures_count_as_missing():
    lat = [0.01] * 90 + [float("inf")] * 10
    st = window_stats(lat, 2.0)
    assert st["p95"] == float("inf")
    assert st["rate"] == 45.0


def test_union_of_overlapping_intervals():
    ivs = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert union_length(ivs) == 15 + 10 + 1
    assert union_length(ivs, 8, 28) == 7 + 8
    assert gaps(ivs, 0, 50) == [(15, 20), (30, 40), (41, 50)]


def test_span_self_time():
    assert self_time((0, 100), [(10, 20), (15, 30), (90, 120)]) == 100 - 20 - 10


def hand_trace():
    # two requests; each has a backbone span and a post span; kernels with
    # their launch times, one overlapping another, and a gap
    units = [(0, 100), (100, 200)]
    spans = [("htd.backbone_fpn", 10, 40), ("htd.post", 60, 90),
             ("htd.backbone_fpn", 110, 140), ("htd.post", 160, 190)]
    device = [("conv", 20, 50, 15), ("deform_conv_fwd_tc_kernel", 30, 45, 20),
              ("nms", 70, 80, 65), ("conv", 120, 150, 115), ("nms", 170, 180, 165)]
    return Trace(units, spans, device, 0, 0, 200)


def test_busy_and_idle_readers():
    tr = hand_trace()
    assert busy_ns(tr) == 30 + 10 + 30 + 10
    idle = harness.load_module("metrics", "device.idle_pct.infer").read(tr, {})
    assert idle == pytest.approx(100.0 * (1 - 80 / 200))


def test_span_readers():
    tr = hand_trace()
    read = lambda name: harness.load_module("metrics", name).read(tr, {})  # noqa: E731
    assert read("post.host_ms") == pytest.approx(30 / 1e6)
    assert read("entry.host_ms") == pytest.approx((100 - 60) / 1e6)
    assert read("backbone_fpn.device_ms") == pytest.approx((30 + 15 + 30) / 2 / 1e6)
    assert read("rpn.host_ms") is None              # no such span: the metric is left out


def test_mfu_reader():
    cfg = tiny_doc()["config"]
    info = {"config": cfg, "units_per_s": 20.0, "window_buckets": [(96, 160)] * 3}
    got = harness.load_module("metrics", "mfu.infer").read(hand_trace(), info)
    assert got == pytest.approx(100.0 * infer_flops(cfg, (96, 160)) * 20.0 / BF16_FLOP_PER_S)


def test_dcn_roofline_reader_needs_its_kernels():
    cfg = tiny_doc("htd_r101_dcn_2x")["config"]
    info = {"config": cfg, "unit_buckets": [(96, 160)] * 2}
    read = harness.load_module("metrics", "dcn_fwd_roofline").read
    from bench_h100.counts.model import dcn_fwd_least_s

    assert read(hand_trace(), info) == pytest.approx(
        100.0 * dcn_fwd_least_s(cfg, (96, 160)) * 1e3 / (15 / 2 / 1e6))
    plain = hand_trace()._replace(device=[d for d in hand_trace().device if "deform" not in d[0]])
    assert read(plain, info) is None


def manifest():
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_the_committed_manifest_passes():
    harness.check_manifest(manifest())


@pytest.mark.parametrize("where,key,value", [
    ("end_to_end", "name", "latency p95"),
    ("per_layer", "name", "dcn/fwd"),
    ("end_to_end", "unit", "images per s"),
    ("end_to_end", "unit", "µs"),
    ("per_layer", "unit", "x" * 17),
    ("workloads", "name", "r50,infer"),
    ("end_to_end", "better", "smaller"),
])
def test_bad_names_and_units_are_rejected(where, key, value):
    m = copy.deepcopy(manifest())
    m[where][0][key] = value
    with pytest.raises(ValueError):
        harness.check_manifest(m)


def test_units_may_hold_slash_and_percent():
    m = copy.deepcopy(manifest())
    m["end_to_end"][0]["unit"] = "images/s"
    m["per_layer"][0]["unit"] = "%"
    harness.check_manifest(m)


def test_every_cell_reports_setup_and_a_per_layer_metric():
    m = manifest()
    for w in m["workloads"]:
        cell = harness.load_cell(w["name"])
        names = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for e in cell.per_layer:
            assert e["moves"] in names
            assert (harness.BENCH / "metrics" / f"{e['name']}.py").exists()


def test_every_seed_gets_the_same_sizes():
    from bench_h100.images import make_pool, pool_sizes

    tp = json.loads((harness.BENCH / "traffic" / "closed_loop_640x480.json").read_text())
    a = sorted(img.shape for img in make_pool(tp, 1))
    b = sorted(img.shape for img in make_pool(tp, 2**31 + 17))
    assert a == b and len(a) == tp["pool"]
    assert [s[:2] for s in a] == sorted(pool_sizes(tp))
    assert not np.array_equal(make_pool(tp, 1)[0], make_pool(tp, 2)[0])
