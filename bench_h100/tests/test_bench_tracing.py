"""The readers of the program's host waits over a hand-made trace:
`preprocess.host_ms`, `sync.host_ms`, `sync.per_request`,
`launches.per_request` and `device.idle_in_sync_pct`, and their entries in
the manifest."""

import json

import pytest

from bench_h100 import harness
from bench_h100.trace import Trace

NEW = ("preprocess.host_ms", "sync.host_ms", "sync.per_request", "launches.per_request",
       "device.idle_in_sync_pct")


def read(name, tr):
    return harness.load_module("metrics", name).read(tr, {})


def waits_trace():
    # request 1 uploads twice in preprocess, checks NMS once inside the RPN
    # span and copies to the host once at top level; request 2 has no sync.
    # The device idles in (0, 5), (7, 14), (45, 58), (70, 93), (95, 112),
    # (150, 165), (175, 200); the gap (95, 112) starts inside the copy's
    # span (92, 96) and ends after it; one record has no launch call.
    units = [(0, 100), (100, 200)]
    spans = [("htd.preprocess", 2, 12), ("htd.sync.upload", 4, 6), ("htd.sync.upload", 8, 10),
             ("htd.backbone_fpn", 12, 40), ("htd.rpn_proposals", 40, 60),
             ("htd.sync.nms", 50, 56), ("htd.post", 60, 90), ("htd.sync.to_host", 92, 96),
             ("htd.preprocess", 102, 110), ("htd.backbone_fpn", 110, 140),
             ("htd.post", 160, 190)]
    device = [("copy", 5, 7, 4), ("conv", 14, 45, 13), ("nms", 58, 70, 57),
              ("d2h", 93, 95, 92), ("conv", 112, 150, 111), ("lost_launch", 165, 175, None)]
    return Trace(units, spans, device, 0, 0, 200)


def test_preprocess_and_sync_host_ms():
    tr = waits_trace()
    assert read("preprocess.host_ms", tr) == pytest.approx((10 + 8) / 2 / 1e6)
    # the union of request 1's four sync spans; request 2 counts as zero
    assert read("sync.host_ms", tr) == pytest.approx((2 + 2 + 6 + 4) / 2 / 1e6)


def test_sync_spans_nested_in_layers_leave_the_union_readers():
    tr = waits_trace()
    plain = tr._replace(spans=[s for s in tr.spans if not s[0].startswith("htd.sync.")])
    for name in ("rpn.host_ms", "post.host_ms", "backbone_fpn.device_ms"):
        assert read(name, tr) == read(name, plain)
    assert read("rpn.host_ms", tr) == pytest.approx(20 / 2 / 1e6)
    # the copy to the host at top level is no longer the entry's own time
    assert read("entry.host_ms", tr) == pytest.approx((100 - 92 + 100 - 68) / 2 / 1e6)


def test_sync_per_request_counts_spans_and_a_unit_with_none():
    assert read("sync.per_request", waits_trace()) == pytest.approx((4 + 0) / 2)


def test_launches_per_request_skips_records_without_a_launch():
    tr = waits_trace()
    assert read("launches.per_request", tr) == pytest.approx(5 / 2)
    outside = tr._replace(device=[("late", 300, 310, 250)] + tr.device)
    assert read("launches.per_request", outside) == pytest.approx(5 / 2)
    assert read("launches.per_request", tr._replace(units=[])) is None


def test_idle_in_sync_takes_the_part_of_each_gap_inside_a_sync_span():
    idle = 5 + 7 + 13 + 23 + 17 + 15 + 25
    # (0, 5) & (4, 6); (7, 14) & (8, 10); (45, 58) & (50, 56); (70, 93) &
    # (92, 96); (95, 112) & (92, 96): the gap that outlasts the span
    waited = 1 + 2 + 6 + 1 + 1
    got = read("device.idle_in_sync_pct", waits_trace())
    assert got == pytest.approx(100.0 * waited / idle)


def test_overlapping_sync_spans_count_once():
    tr = waits_trace()
    doubled = tr._replace(spans=sorted(tr.spans + [("htd.sync.nms", 52, 57)],
                                       key=lambda s: s[1]))
    # (45, 58) & (50, 57) is 7 long where (50, 56) was 6
    idle = 5 + 7 + 13 + 23 + 17 + 15 + 25
    assert read("device.idle_in_sync_pct", doubled) == pytest.approx(100.0 * 12 / idle)
    assert read("sync.host_ms", doubled) == pytest.approx((2 + 2 + 7 + 4) / 2 / 1e6)


def test_no_sync_span_reads_none():
    tr = waits_trace()
    # the parent's program: layer spans only
    parent = tr._replace(spans=[s for s in tr.spans if s[0] not in (
        "htd.preprocess", "htd.sync.upload", "htd.sync.nms", "htd.sync.to_host")])
    for name in ("preprocess.host_ms", "sync.host_ms", "sync.per_request",
                 "device.idle_in_sync_pct"):
        assert read(name, parent) is None, name
    assert read("launches.per_request", parent) == pytest.approx(5 / 2)


def test_the_manifest_reports_the_new_metrics_in_both_inference_cells():
    m = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    harness.check_manifest(m)
    new = [e for e in m["per_layer"] if e["name"] in NEW]
    assert [e["name"] for e in m["per_layer"][-len(NEW):]] == list(NEW) == [e["name"] for e in new]
    for cell in ("r50.infer", "r101dcn.infer"):
        names = {e["name"] for e in harness.load_cell(cell).per_layer}
        assert set(NEW) <= names
    for e in new:
        assert e["workloads"] == ["r50.infer", "r101dcn.infer"]
        assert (harness.BENCH / "metrics" / f"{e['name']}.py").exists()
