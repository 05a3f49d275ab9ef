"""Data parallelism (`htd_tpu_torch.parallel`): two gloo ranks on the CPU
against the JAX package's meshed step and one-process evaluation, on the
tiny config.

One module-scoped fixture spawns the two ranks once
(`tests/torch_parallel_worker.py`). Each takes a float32 step on its half
of a global batch of 4 with its own injected samples; the JAX package's
update is `value_and_grad` of `forward_train` on each half with the same
samples, averaged, then its optax SGD (what the meshed step's
`update_program` computes, htd_tpu/train/train_step.py:225-248). The ranks
then take two sampled steps and evaluate a mini-COCO together. The tools
run under `torchrun --standalone`.
"""

import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from htd_tpu.parallel.mesh import host_slice as jax_host_slice
from htd_tpu.train import optim as JO
from htd_tpu_torch.apis import evaluate_dataset, init_detector
from htd_tpu_torch.data.coco import CocoDataset
from htd_tpu_torch.parallel import host_slice, init_distributed, rank_device
from htd_tpu_torch.train.checkpoint import save_checkpoint
from htd_tpu_torch.train.optim import make_optimizer
from htd_tpu_torch.train.train_step import TrainState, step_generator
from htd_tpu_torch.weights import state_dict_from_flax
from tests import torch_parallel_worker
from tests.test_torch_train import B, H, IMG_SHAPES, LOSS_KEYS, W, _gts, _overrides
from tests.torch_port import tiny_pair
from tools_torch import test as ptest

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny config as the tools' --set options (a number indexes a tuple)
TINY_SET = ["backbone.depth=10", "test_scale=96,64", "proposal_test.nms_pre=64",
            "proposal_test.nms_post=48", "proposal_test.max_num=48", "rcnn_test.max_per_img=10"]
TINY_TRAIN_SET = ["train.img_scale=96,64", "train.total_epochs=1", "train.max_gt=8",
                  "train.rcnn_pos_cap=8", "train.rpn_proposal.nms_pre=64",
                  "train.rpn_proposal.nms_post=48", "train.rpn_proposal.max_num=48",
                  "train.rpn_sampler.num=32", "train.rcnn.0.sampler.num=32",
                  "train.rcnn.1.sampler.num=32"]


def _ladder(name):
    """tests/test_torch_train.py's gradient tolerances by parameter group."""
    return 2e-2 if name.startswith("backbone.") else 1e-2 if name.startswith("neck.") else 5e-3


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """Seven PNG images (60x90 landscape, 90x60 portrait), two or three
    annotations each over categories 1 and 3, one box over most of the
    image."""
    root = tmp_path_factory.mktemp("pngcoco")
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(7):
        h, w = (60, 90) if i % 2 == 0 else (90, 60)
        cv2.imwrite(str(root / f"img{i}.png"), rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i + 1, file_name=f"img{i}.png", height=h, width=w))
        boxes = [[rng.uniform(0, w / 2), rng.uniform(0, h / 2), rng.uniform(8, w / 2),
                  rng.uniform(8, h / 2)] for _ in range(1 + i % 2)] + [[2.0, 1.0, w - 3.0, h - 4.0]]
        for b in boxes:
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=int(rng.choice([1, 3])),
                             bbox=[float(v) for v in b], area=float(b[2] * b[3]), iscrowd=0))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns, categories=[
        dict(id=1, name="a"), dict(id=3, name="b")])))
    return str(ann), str(root)


def _save(port, path):
    save_checkpoint(str(path), TrainState(port, make_optimizer(port.cfg.train, port), 0, 1))


@pytest.fixture(scope="module")
def eval_checkpoint(tmp_path_factory):
    """The tiny detector (seed 31) with its box regressions scaled by 1/10
    and both stages' logits of labels 0 and 1 raised, so that detections
    reach the gts with the dataset's labels (tests/test_torch_tools.py)."""
    _, _, _, port = tiny_pair(seed=31)
    with torch.no_grad():
        for m in (port.rpn_head.rpn_reg, *(h.fc_reg for h in port.roi_head.bbox_head)):
            for p in m.parameters():
                p.mul_(0.1)
        for head in port.roi_head.bbox_head:
            head.fc_cls.bias[:2] += 3.0
    path = tmp_path_factory.mktemp("eval_ckpt") / "tiny.pth"
    _save(port, path)
    return str(path), port.cfg


def _halves(cfg):
    """Each rank's half of the global batch (images, shapes, gts) and its
    injected samples, from seeds."""
    n_anchors = 3 * sum((H // s) * (W // s) if s < 64 else 2 for s in (4, 8, 16, 32, 64))
    batches, overrides = [], []
    for r in range(2):
        rng = np.random.RandomState(40 + r)
        images = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
        batches.append((images, IMG_SHAPES) + _gts(rng, cfg.train.max_gt))
        overrides.append(_overrides(50 + r, cfg, n_anchors))
    return batches, overrides


def _jax_update(cfg, jm, variables, port, batches, overrides):
    """The JAX package's meshed step on the same halves: per-half loss
    terms, the mean gradient and the parameters before and after the
    update, mapped onto the port's names."""
    def total(params, inputs, ov):
        losses = jm.apply(dict(variables, params=params), *inputs, overrides=ov,
                          method=jm.forward_train, rngs={"sampling": jax.random.PRNGKey(0)})
        return sum(v for k, v in losses.items() if "loss" in k), losses

    grad_fn = jax.jit(jax.value_and_grad(total, has_aux=True))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    halves = []
    for inputs, ov in zip(batches, overrides):
        (tot, losses), grads = grad_fn(params, tuple(map(jnp.asarray, inputs)),
                                       {k: jnp.asarray(v) for k, v in ov.items()})
        halves.append(({"loss": float(tot), **{k: float(v) for k, v in losses.items()}}, grads))
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, halves[0][1], halves[1][1])
    tx = JO.make_optimizer(cfg.train, params, 7330)
    updates, _ = tx.update(mean, tx.init(params), params)
    new = optax.apply_updates(params, updates)

    def mapped(tree):
        return state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, tree),
                                     "batch_stats": variables["batch_stats"]}, port.cfg)

    return [h[0] for h in halves], mapped(mean), mapped(params), mapped(new)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, mini_coco, eval_checkpoint):
    """Both ranks' results (the JAX package's update computed while they
    run), and the inputs they were given."""
    root = tmp_path_factory.mktemp("ranks")
    cfg, jm, variables, port = tiny_pair(seed=3)
    _save(port, root / "train.pth")
    batches, overrides = _halves(cfg)
    ann, img_root = mini_coco
    job = dict(cfg=port.cfg, train_ckpt=str(root / "train.pth"), batches=batches,
               overrides=overrides, eval_cfg=eval_checkpoint[1], eval_ckpt=eval_checkpoint[0],
               ann=ann, img_root=img_root)
    ctx = mp.start_processes(torch_parallel_worker.rank_main, args=(str(root), job), nprocs=2,
                             join=False, start_method="spawn")
    jax_update = _jax_update(cfg, jm, variables, port, batches, overrides)
    while not ctx.join():
        pass
    out = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return dict(out=out, root=root, job=job, jax=jax_update)


@pytest.fixture(scope="module")
def jax_update(ranks):
    return ranks["jax"]


@pytest.mark.parametrize("n,count,pid", [(8, 2, 0), (8, 2, 1), (8, 4, 3), (6, 3, 2), (4, 1, 0),
                                         (2, 2, 1)])
def test_host_slice_matches_jax(n, count, pid):
    items = [f"rec{i}" for i in range(n)]
    assert host_slice(items, pid, count) == jax_host_slice(items, pid, count)
    flips = list(np.random.RandomState(n).rand(n) < 0.5)
    assert host_slice(flips, pid, count) == jax_host_slice(flips, pid, count)


@pytest.mark.parametrize("n,count", [(5, 2), (3, 2), (7, 4)])
def test_host_slice_raises_as_jax(n, count):
    items = list(range(n))
    with pytest.raises(AssertionError) as jax_err:
        jax_host_slice(items, 0, count)
    with pytest.raises(AssertionError) as port_err:
        host_slice(items, 0, count)
    assert str(port_err.value) == str(jax_err.value)


def test_host_slice_without_group_is_everything():
    assert host_slice([1, 2, 3]) == [1, 2, 3]


def test_no_silent_backend_or_device(monkeypatch, tmp_path):
    """The caller names the backend, and a rank runs on the CPU only when
    asked: without CUDA a rank's device raises, NCCL refuses the CPU, an
    unknown backend and a missing torchrun environment raise, all before
    any group is joined."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rank_device(3, "cpu") == torch.device("cpu")
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device(0, device)
    rdzv = f"file://{tmp_path}/rendezvous"
    with pytest.raises(ValueError, match="NCCL takes CUDA tensors"):
        init_distributed("nccl", rdzv, rank=0, world_size=1, device="cpu")
    with pytest.raises(ValueError, match="expected one of"):
        init_distributed("mpi", rdzv, rank=0, world_size=1, device="cpu")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        init_distributed("gloo", device="cpu")
    with pytest.raises(RuntimeError, match="MASTER_ADDR is not set"):
        init_distributed("gloo", rank=0, world_size=1, device="cpu")
    assert not torch.distributed.is_initialized()


def test_step_generator_at_world_size_1_is_unchanged():
    """At one rank the stream is `SeedSequence([seed, step])`'s, as before
    ranks existed (so that resumed one-process runs stay bit-exact); each of
    several ranks draws its own, from `SeedSequence([seed, step, rank])`
    (numpy's entropy ignores trailing zeros, so rank 0's is the one-process
    stream)."""
    def draw(gen):
        return torch.rand(8, generator=gen)

    for seed, step in ((0, 0), (3, 17)):
        entropy = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
        ref = draw(torch.Generator().manual_seed(int(entropy)))
        assert torch.equal(draw(step_generator(seed, step, "cpu")), ref)
        assert torch.equal(draw(step_generator(seed, step, "cpu", rank=0, world_size=1)), ref)
        r0, r1 = (draw(step_generator(seed, step, "cpu", r, 2)) for r in range(2))
        assert torch.equal(r0, ref) and not torch.equal(r1, ref)
        words = np.random.SeedSequence([seed, step, 1]).generate_state(1, np.uint64)[0]
        assert torch.equal(r1, draw(torch.Generator().manual_seed(int(words))))


def test_two_rank_step_matches_jax_gradients(ranks, jax_update):
    """Both ranks hold the mean gradient of the JAX package's halves within
    tests/test_torch_train.py's ladder (backbone 2e-2, neck 1e-2, heads
    5e-3 of the leaf's largest value), bit-identical to each other."""
    _, grads, _, _ = jax_update
    got = ranks["out"][0]["grads"]
    assert set(got) == {n for n, p in ranks["out"][0]["after"].items()
                        if not n.startswith(("backbone.conv1.", "backbone.bn1.",
                                             "backbone.layer1."))}
    for name, g in got.items():
        assert torch.equal(g, ranks["out"][1]["grads"][name]), name
    scale = max(float(g.abs().max()) for g in got.values())
    failures = []
    for name, g in got.items():
        ours, ref = g.double().numpy(), grads[name].double().numpy()
        denom = max(np.abs(ours).max(), np.abs(ref).max())
        if denom <= 1e-9 * max(scale, 1.0):
            continue
        err = np.abs(ours - ref).max() / denom
        if err > _ladder(name):
            failures.append(f"{name} rel {err:.2e}")
    assert not failures, "; ".join(failures)


def test_two_rank_step_matches_jax_update(ranks, jax_update):
    """The parameters after the step: each leaf's update within the
    gradient ladder of the leaf's largest update (beyond two float32 ulps
    of the parameter), the stem and layer1 unchanged in both packages."""
    _, _, before, after = jax_update
    out = ranks["out"][0]
    failures = []
    for name, p in out["after"].items():
        assert torch.equal(out["before"][name], before[name]), name
        ours, ref = (p - out["before"][name]).double(), (after[name] - before[name]).double()
        if name not in out["grads"]:
            assert not ours.any() and not ref.any(), name
            continue
        ulps = 2 * (torch.nextafter(p.abs(), torch.tensor(np.inf)) - p.abs()).double()
        err = float(((ours - ref).abs() - ulps).clamp(min=0).max()) / max(
            float(ref.abs().max()), 1e-30)
        if err > _ladder(name):
            failures.append(f"{name} rel {err:.2e}")
    assert not failures, "; ".join(failures)


def test_two_rank_loss_metrics_are_the_halves_mean(ranks, jax_update):
    """The step's loss terms are the mean of the ranks' own terms (as the
    packed vector carried them), equal on both ranks, and within 1e-4 of
    the mean of the JAX package's halves."""
    halves, _, _, _ = jax_update
    a, b = ranks["out"]
    assert a["metrics"] == b["metrics"]
    assert set(a["metrics"]) == set(LOSS_KEYS) | {"loss", "s0.acc", "s1.acc"}
    for k, v in a["metrics"].items():
        local = np.float32(a["local"][k]) + np.float32(b["local"][k])
        assert v == pytest.approx(float(local / np.float32(2)), rel=1e-7, abs=1e-9), k
        ref = (halves[0][k] + halves[1][k]) / 2
        assert abs(v - ref) <= 1e-4 * max(abs(ref), 1e-3), (k, v, ref)
    n_params = sum(g.numel() for g in a["grads"].values())
    assert a["packed_size"] == n_params + len(a["metrics"])


def test_two_ranks_stay_bit_identical(ranks):
    assert [o["identical"] for o in ranks["out"]] == [[True, True]] * 2


def test_missing_gradient_packs_as_zeros(ranks):
    """A parameter whose gradient is None on rank 1 gets rank 0's gradient
    halved on both ranks; the other gradients and the terms are means."""
    for out in ranks["out"]:
        g = out["none_grad"]["grads"]
        assert torch.equal(g[0], torch.full((2, 3), 0.5))
        assert torch.equal(g[1], torch.full((2,), 2.5))
        assert torch.equal(g[2], torch.full((1, 2), 3.5))
        assert {k: float(v) for k, v in out["none_grad"]["metrics"].items()} == \
            {"loss": 1.0, "b": 1.0}


def test_two_rank_evaluation_matches_one_rank(ranks, mini_coco):
    """evaluate_dataset over the two ranks at batch 2 each (every rank the
    metrics of all) equals one process at batch 2: the same batches, so
    the same detections, bit for bit, in the dataset's order."""
    ann, img_root = mini_coco
    job = ranks["job"]
    model = init_detector(job["eval_cfg"], job["eval_ckpt"], device="cpu")
    metrics, dets = evaluate_dataset(model, CocoDataset(ann, img_root, test_mode=True),
                                     batch_size=2, scale=(96, 64), log_every=0,
                                     return_detections=True)
    assert metrics["mAP_50"] > 0
    for out in ranks["out"]:
        m2, d2 = out["eval"]
        assert json.dumps(m2) == json.dumps(metrics)
        assert list(d2) == list(dets) and sorted(dets) == list(range(1, 8))
        for k in dets:
            for x, y in zip(dets[k], d2[k]):
                assert np.array_equal(x, y), k


def test_root_logger_writes_on_rank_0_only(ranks):
    logs = sorted(os.listdir(ranks["root"] / "logs"))
    assert logs == ["rank0.log"]
    lines = (ranks["root"] / "logs" / "rank0.log").read_text().splitlines()
    assert len(lines) == 1 and lines[0].endswith("rank 0 joined")


def _torchrun(args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2"] + args
    done = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    return done.stdout


def test_torchrun_tools(mini_coco, eval_checkpoint, tmp_path):
    """`torchrun --standalone --nproc_per_node 2` runs train.py over two
    gloo ranks on the CPU: one checkpoint and one log, written by rank 0,
    no line twice; test.py --chips 2 (and test.py --distributed under
    torchrun) prints the metrics of --chips 1 at the same per-rank batch."""
    ann, img_root = mini_coco
    work = tmp_path / "work"
    stdout = _torchrun([os.path.join(REPO, "tools_torch", "train.py"), "--distributed",
                        "--dist-backend", "gloo", "--device", "cpu", "--train-ann", ann,
                        "--train-img", img_root, "--work-dir", str(work), "--batch-size", "2",
                        "--log-interval", "1", "--set"] + TINY_SET + TINY_TRAIN_SET, REPO)
    assert sorted(os.listdir(work)) == ["config.json", "epoch_1.pth", "train.log",
                                        "train.log.json"]
    records = [json.loads(line) for line in (work / "train.log.json").read_text().splitlines()]
    assert [(r["epoch"], r["iter"]) for r in records] == [(1, 1), (1, 2), (1, 3)]
    assert all(np.isfinite(r["loss"]) for r in records)
    printed = [line for line in stdout.splitlines() if line.startswith("{")]
    assert [json.loads(line) for line in printed] == records
    log = (work / "train.log").read_text().splitlines()
    assert len(log) == len(set(log)) and sum("saved" in line for line in log) == 1
    assert any('"world_size": 2' in line for line in log)
    meta = torch.load(work / "epoch_1.pth", weights_only=True)["meta"]
    assert (meta["step"], meta["steps_per_epoch"], meta["epoch"]) == (3, 3, 1)

    ckpt, _ = eval_checkpoint
    args = ["--checkpoint", ckpt, "--ann", ann, "--img-root", img_root, "--device", "cpu",
            "--dist-backend", "gloo", "--scale", "96x64", "--set"] + TINY_SET
    one = ptest.main(args + ["--batch-size", "1", "--dump", str(tmp_path / "one.json")])
    two = ptest.main(args + ["--batch-size", "2", "--chips", "2",
                             "--dump", str(tmp_path / "two.json")])
    assert one["mAP_50"] > 0 and json.dumps(two) == json.dumps(one)
    assert (tmp_path / "two.json").read_bytes() == (tmp_path / "one.json").read_bytes()
    stdout = _torchrun([os.path.join(REPO, "tools_torch", "test.py"), "--distributed",
                        "--batch-size", "1"] + args, REPO)
    assert [line for line in stdout.splitlines() if line.startswith("{")] == [json.dumps(one)]


def test_test_tool_rejects_what_ranks_do_not_cover(mini_coco):
    ann, img_root = mini_coco
    base = ["--ann", ann, "--img-root", img_root, "--device", "cpu"]
    for extra in (["--chips", "2", "--aug"], ["--chips", "2", "--eval", "proposal"],
                  ["--chips", "2", "--batch-size", "3"]):
        with pytest.raises(ValueError):
            ptest.main(base + extra)
