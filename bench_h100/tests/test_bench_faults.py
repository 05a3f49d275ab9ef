"""The harness run through, on the CPU at the tiny configuration and in
float32, with the look for a card skipped: a sound program comes out
`correct`, and the timed path broken underneath comes out not correct,
once for each fault a cell can have. Each cell's own limits are used."""

import time

import pytest

from bench_h100 import faults, harness
from bench_h100.tests.tiny import tiny_doc


def run_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_h100_run", harness.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_cell(traffic: str):
    """The r101dcn.train.ms cell, loaded from BENCHMARK.json with the training
    cells' pending entries (bench_h100/pending.json) added, on `traffic`."""
    import json

    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pending = json.loads((harness.BENCH / "pending.json").read_text())
    for group in ("workloads", "end_to_end", "per_layer"):
        manifest[group] = manifest[group] + pending[group]
    cell = harness.load_cell("r101dcn.train.ms", manifest=manifest)
    cell.traffic = json.loads((harness.BENCH / "traffic" / f"{traffic}.json").read_text())
    return cell


def tiny_cell(name: str, config: str, **traffic):
    real = train_cell("mstrain_batch2") if name == "r101dcn.train.ms" else harness.load_cell(name)
    doc = tiny_doc(config)
    if real.traffic["generator"] == "closed_loop_infer":
        doc["assumed"]["score_scale"] = 30.0
        tp = dict(real.traffic, pool=6, sizes=[[120, 160], [160, 120]], trace_units=2, check_requests=3)
    else:
        tp = dict(real.traffic, pool=6, sizes=[[120, 160], [160, 120]], scales=[[160, 96]], gts=[2, 6],
                  trace_units=1)
    tp.update(traffic)
    return harness.Cell(name, 1, doc, tp, real.limits, real.end_to_end, real.per_layer)


def outcome(cell, program=None, trace=False, seconds=0.5):
    ctx = harness.Context(cell, 2**31 + 11, seconds, trace, time.perf_counter(), device="cpu",
                          program=program)
    rc, result = run_module().execute(cell, ctx, {"platform": "cpu", "count": 1})
    assert rc == 0
    return result


INFER = [("r50.infer", "htd_r50_1x"), ("r101dcn.infer", "htd_r101_dcn_2x")]


@pytest.mark.parametrize("name,config", INFER)
def test_sound_inference_is_correct(name, config):
    res = outcome(tiny_cell(name, config), trace=True)
    assert res["correct"], res["compared"]
    assert list(res)[-1] == "compared"
    assert "entry.host_ms" in res["metrics"]


@pytest.mark.parametrize("name,config", INFER)
@pytest.mark.parametrize("fault", faults.INFERENCE, ids=lambda f: f.__name__)
def test_broken_inference_is_not_correct(name, config, fault):
    assert not outcome(tiny_cell(name, config), program=fault)["correct"]


def test_sound_training_is_correct():
    res = outcome(tiny_cell("r101dcn.train.ms", "htd_r101_dcn_2x"), trace=True, seconds=0.1)
    assert res["correct"], res["compared"]
    assert "train.forward_host_ms" in res["metrics"]


@pytest.mark.parametrize("fault", faults.TRAINING, ids=lambda f: f.__name__)
def test_broken_training_is_not_correct(fault):
    cell = tiny_cell("r101dcn.train.ms", "htd_r101_dcn_2x")
    assert not outcome(cell, program=fault, seconds=0.1)["correct"]


def dp_cell():
    """The data-parallel generator's cell at the tiny size over two ranks,
    held to the training cell's limits and, exactly, to every rank holding
    rank 0's parameters."""
    train = train_cell("fixed_batch2_dp4")
    tp = dict(train.traffic)
    tp.update(ranks=2, pool=6, sizes=[[120, 160], [160, 120]], scales=[[160, 96]], gts=[2, 6],
              trace_units=1)
    limits = {"numbers": {k: v for k, v in train.limits["numbers"].items()
                          if k != "dcn_update_median_gap"}}
    limits["numbers"]["rank_gap"] = {"limit": 0.0}
    return harness.Cell("r50.train.dp4", 4, tiny_doc("htd_r50_1x"), tp, limits,
                        train.end_to_end, [])


@pytest.mark.parametrize("fault", [None, faults.no_exchange, faults.loads_jax],
                         ids=["sound", "no_exchange", "loads_jax"])
def test_data_parallel_over_two_gloo_ranks(fault):
    """Two ranks on the CPU: the sound program is correct with every rank's
    parameters equal; without the exchange the ranks part and it is not; a
    rank that loaded JAX fails the run, with no result."""
    if fault is faults.loads_jax:
        with pytest.raises(SystemExit) as exc:
            outcome(dp_cell(), program=fault, seconds=0.1)
        assert exc.value.code == 4
        return
    res = outcome(dp_cell(), program=fault, seconds=0.1)
    assert res["correct"] == (fault is None), res["compared"]


@pytest.mark.parametrize("name,config", INFER)
def test_failed_requests_are_not_correct(name, config):
    """A request that raises counts as failed, and one failed request is not
    correct, however well the others compare."""
    calls = []

    def third_fails(model, img):
        from htd_tpu_torch.apis import inference_detector

        calls.append(1)
        if len(calls) == 3:                        # the two warm-up calls pass
            raise RuntimeError("planted failure")
        return inference_detector(model, img)

    from bench_h100.reference.judge import held

    cell = tiny_cell(name, config)
    ctx = harness.Context(cell, 2**31 + 11, 0.5, False, time.perf_counter(), device="cpu",
                          program=third_fails)
    out = harness.load_module("generators", cell.traffic["generator"]).run(ctx)
    assert out.failed == 1 and out.attempted > 1
    ok, rows = held(out.numbers, cell.limits["numbers"], out.failed)
    assert not ok and ("failed", 1.0, 0.0) in rows
    assert held(out.numbers, cell.limits["numbers"])[0]      # the rest compare well
