"""The plain reference held to the program (`htd_tpu_torch`) on the CPU at
the tiny configuration, in float32, from the benchmark's own weights: a
frozen copy that drifts from the port shows here, not on the card. This
is the one file of the benchmark that imports both."""

import numpy as np
import pytest
import torch

from bench_h100.harness import port_config
from bench_h100.program import build_detector
from bench_h100.reference.detector import Reference
from bench_h100.tests.tiny import tiny_doc
from bench_h100.weights import make_state_dict


def pair(config, seed=5):
    doc = tiny_doc(config)
    doc["assumed"]["score_scale"] = 30.0          # detections from a depth-10 net
    model = build_detector(port_config(doc), make_state_dict(doc["config"], doc["assumed"],
                                                             seed, "cpu"), "cpu")
    ref = Reference(doc["config"], make_state_dict(doc["config"], doc["assumed"], seed, "cpu"))
    return model, ref


@pytest.mark.parametrize("config", ["htd_r50_1x", "htd_r101_dcn_2x"])
@pytest.mark.parametrize("hw", [(120, 160), (160, 90)])
def test_detections_match_the_program(config, hw):
    from htd_tpu_torch.apis import inference_detector

    model, ref = pair(config)
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    pb, ps, pl = inference_detector(model, img)
    (sb, ss, sl), (rb, rs, rl) = ref.detect(img)
    assert len(pb) == len(sb) > 0
    np.testing.assert_array_equal(pl, sl)
    np.testing.assert_allclose(pb, sb, atol=1e-3)
    np.testing.assert_allclose(ps, ss, atol=1e-5)
    # the relaxed set begins with the strict one
    np.testing.assert_array_equal(rl[:len(sl)], sl)
    assert len(rb) >= len(sb)


def test_weights_are_the_programs_state_dict():
    doc = tiny_doc("htd_r101_dcn_2x")
    sd = make_state_dict(doc["config"], doc["assumed"], 3, "cpu")
    model = build_detector(port_config(doc), dict(sd), "cpu")
    assert set(model.state_dict()) == set(sd)
    again = make_state_dict(doc["config"], doc["assumed"], 3, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("config", ["htd_r50_1x", "htd_r101_dcn_2x"])
def test_train_steps_match_the_program(config):
    """Two SGD steps from the same weights, batches and sampling draws: the
    reference's losses and gradients are the program's, float32 on the CPU
    (leaves whose gradient is nought to rounding left out, as the judge
    leaves them out)."""
    import json

    from htd_tpu_torch.data.coco import make_train_batch
    from htd_tpu_torch.train.train_step import train_step

    from bench_h100.generators import train_steps as T
    from bench_h100.harness import BENCH
    from bench_h100.program import build_train_state
    from bench_h100.reference.ops import bucket_shape
    from bench_h100.reference.train import TrainReference, make_batch

    doc = tiny_doc(config)
    tp = json.loads((BENCH / "traffic" / "mstrain_batch2.json").read_text())
    tp.update(pool=6, sizes=[[120, 160], [160, 120]], scales=[[160, 96], [200, 128]], gts=[2, 6])
    feed = T.Feed(doc["config"], tp, 77)
    data = T._Records(feed)
    state = build_train_state(port_config(doc), make_state_dict(doc["config"], doc["assumed"],
                                                                77, "cpu"), "cpu")
    ref = TrainReference(doc["config"], make_state_dict(doc["config"], doc["assumed"], 77, "cpu"))
    params = dict(state.model.named_parameters())
    for k in range(2):
        scale, ids, flips = feed.step(k)
        got = train_step(state, make_train_batch(
            data, [data.record(i) for i in ids], scale=scale,
            max_gt=doc["config"]["train"]["max_gt"], flips=flips, device="cpu"),
            generator=feed.generator(k, "cpu"))
        land = feed.pool[ids[0]].shape[1] >= feed.pool[ids[0]].shape[0]
        batch = make_batch([feed.pool[i] for i in ids], [feed.gts[i][0] for i in ids],
                           [feed.gts[i][1] for i in ids], flips, scale, bucket_shape(scale, land),
                           doc["config"]["train"]["max_gt"], "cpu")
        want, grads = ref.step_mean([batch], [feed.generator(k, "cpu")], k, T.STEPS_PER_EPOCH)
        for key, v in want.items():
            assert float(got[key]) == pytest.approx(float(v), rel=1e-5, abs=1e-7), key
        norms = {n: float(g.norm()) for n, g in grads.items()}
        med = float(np.median(list(norms.values())))
        for n, g in grads.items():
            if norms[n] >= 1e-3 * med:
                err = float((params[n].grad - g).norm()) / max(norms[n], med)
                assert err < 1e-3, (k, n, err)
