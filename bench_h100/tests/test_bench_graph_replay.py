"""The reader of `backbone_fpn.graph_replay_pct` over hand-made traces,
and its entry in the manifest."""

import json

from bench_h100 import harness
from bench_h100.trace import Trace

NAME = "backbone_fpn.graph_replay_pct"


def read(tr):
    return harness.load_module("metrics", NAME).read(tr, {})


def trace(spans, units=((0, 100), (100, 200), (200, 300), (300, 400))):
    return Trace(list(units), sorted(spans, key=lambda s: s[1]), [], 0, 0, 400)


def test_the_share_of_requests_whose_backbone_replayed():
    # request 1 captures then replays, 2 and 3 replay, 4 runs eagerly; a
    # replay span outside any backbone span counts for no request
    spans = [("htd.backbone_fpn", 10, 60), ("htd.graph.capture", 11, 50),
             ("htd.graph.replay", 51, 55), ("htd.backbone_fpn", 110, 120),
             ("htd.graph.replay", 111, 119), ("htd.backbone_fpn", 210, 220),
             ("htd.graph.replay", 211, 219), ("htd.backbone_fpn", 310, 360),
             ("htd.dcn", 320, 330), ("htd.graph.replay", 370, 375)]
    assert read(trace(spans)) == 75.0


def test_every_request_replayed_reads_100():
    spans = [s for u in range(4) for s in (("htd.backbone_fpn", 100 * u + 10, 100 * u + 20),
                                           ("htd.graph.replay", 100 * u + 11, 100 * u + 19))]
    assert read(trace(spans)) == 100.0


def test_eager_requests_read_0_and_no_backbone_reads_none():
    eager = [("htd.backbone_fpn", 100 * u + 10, 100 * u + 20) for u in range(4)]
    assert read(trace(eager)) == 0.0
    assert read(trace([("htd.post", 10, 20)])) is None
    assert read(trace(eager, units=())) is None


def test_the_manifest_entry():
    doc = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in doc["per_layer"] if m["name"] == NAME)
    assert doc["per_layer"][-1] is entry
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_span",
                     "layer": "backbone and FPN", "moves": "images_per_s",
                     "workloads": ["r50.infer", "r101dcn.infer", "x101dcn.infer"]}
