"""The port's checkpoints (`htd_tpu_torch.train.checkpoint`, CPU, tiny
config): a train run cut by a save and a restore continues bit for bit,
`merge_pretrained` overlays a partial state dict, and a file the port saves
loads into the JAX package and into `init_detector` with the same
detections."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htd_tpu.train import checkpoint as jckpt
from htd_tpu_torch.apis import init_detector
from htd_tpu_torch.models.detector import HTDDetector
from htd_tpu_torch.train.checkpoint import (load_torch_checkpoint, merge_pretrained,
                                            restore_checkpoint, save_checkpoint)
from htd_tpu_torch.train.optim import make_optimizer
from htd_tpu_torch.train.train_step import (TrainBatch, TrainState, create_train_state,
                                            step_generator, train_step)
from htd_tpu_torch.weights import init_random
from tests.test_e2e_parity import _assert_rows_match_or_tie
from tests.torch_port import port_config, t, tiny_pair
from tests.tiny import tiny_config

torch.set_num_threads(1)
B, H, W = 2, 64, 96
IMG_SHAPES = np.array([[60.0, 90.0], [64.0, 80.0]], np.float32)
SEED = 11


def _batch(rng, max_gt):
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.zeros((B, max_gt), np.int32)
    valid = np.zeros((B, max_gt), bool)
    for i in range(B):
        h, w = IMG_SHAPES[i]
        for g, (lo, hi) in enumerate([(10, 24), (20, 40), (40, 60)]):
            bw, bh = rng.uniform(lo, hi, 2)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, g] = [x1, y1, x1 + bw, y1 + bh]
            labels[i, g] = rng.randint(0, 80)
            valid[i, g] = True
    images = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    return TrainBatch(t(images), t(IMG_SHAPES), t(boxes), t(labels), t(valid))


def _steps(state, batches, n):
    return [train_step(state, batches[state.step % len(batches)],
                       step_generator(SEED, state.step, "cpu")) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_restore_resumes_bit_for_bit(tmp_path, dtype):
    """4 `train_step`s in one go equal 2 steps, `save_checkpoint`,
    `restore_checkpoint` into a fresh state (other random weights), and 2
    more: every loss term of steps 3-4, every tensor of the model and
    every momentum buffer, bit for bit; the file's meta carries the step,
    the steps per epoch, the epoch and the config. (The run saves after its
    second step, which changes nothing in it.)"""
    cfg = port_config(tiny_config(compute_dtype=dtype))
    rng = np.random.RandomState(4)
    batches = [_batch(rng, cfg.train.max_gt) for _ in range(2)]
    whole = create_train_state(cfg, device="cpu", seed=0, steps_per_epoch=2)
    losses = _steps(whole, batches, 2)
    path = str(tmp_path / "epoch_1.pth")
    save_checkpoint(path, whole, meta={"note": "cut"})
    losses += _steps(whole, batches, 2)

    fresh = create_train_state(cfg, device="cpu", seed=1, steps_per_epoch=9)
    restore_checkpoint(path, fresh)
    assert (fresh.step, fresh.steps_per_epoch) == (2, 2)
    resumed = _steps(fresh, batches, 2)

    for a, b in zip(losses[2:], resumed):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    sd_a, sd_b = whole.model.state_dict(), fresh.model.state_dict()
    assert set(sd_a) == set(sd_b)
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    opt_a, opt_b = whole.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert set(opt_a) == set(opt_b) and len(opt_a) > 0
    for i in opt_a:
        assert torch.equal(opt_a[i]["momentum_buffer"], opt_b[i]["momentum_buffer"]), i
    meta = torch.load(path, weights_only=True)["meta"]
    assert meta["step"] == 2 and meta["steps_per_epoch"] == 2 and meta["epoch"] == 1
    assert meta["note"] == "cut" and f'"compute_dtype": "{dtype}"' in meta["config"]


def test_merge_pretrained_backbone_only(tmp_path):
    """A backbone-only dict (plus a classifier the detector lacks) over a
    fresh model: the backbone takes the dict's values, the neck and heads
    keep their fresh values, the head names come back missing and the
    classifier unexpected; `create_train_state(pretrained=)` does the same
    from a file; a tensor of another shape raises before anything is
    copied."""
    cfg = port_config(tiny_config())
    donor = init_random(HTDDetector(cfg), seed=1).state_dict()
    backbone = {k: v for k, v in donor.items() if k.startswith("backbone.")}
    extra = {"backbone.fc.weight": torch.zeros(10, 4)}
    model = init_random(HTDDetector(cfg), seed=0)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    missing, unexpected = merge_pretrained(model, {**backbone, **extra})
    assert unexpected == ["backbone.fc.weight"]
    assert set(missing) == set(fresh) - set(backbone)
    assert any(k.startswith("roi_head.") for k in missing) and missing
    for k, v in model.state_dict().items():
        want = backbone[k] if k in backbone else fresh[k]
        assert torch.equal(v, want), k
    assert not torch.equal(backbone["backbone.layer2.0.conv1.weight"],
                           fresh["backbone.layer2.0.conv1.weight"])

    path = str(tmp_path / "backbone.pth")
    torch.save({"state_dict": {**backbone, **extra}}, path)
    state = create_train_state(cfg, device="cpu", seed=0, pretrained=path)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, backbone[k] if k in backbone else fresh[k]), k

    bad = dict(backbone)
    bad["backbone.conv1.weight"] = torch.zeros(3, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model2 = init_random(HTDDetector(cfg), seed=0)
    with pytest.raises(ValueError, match="backbone.conv1.weight"):
        merge_pretrained(model2, bad)
    for k, v in model2.state_dict().items():
        assert torch.equal(v, fresh[k]), k
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_port_checkpoint_loads_into_jax(tmp_path):
    """A `.pth` that `save_checkpoint` wrote loads into the JAX package
    through its `load_torch_checkpoint`, and into the port through
    `init_detector` and `load_torch_checkpoint`; both give the same
    detections on one image, within `tests/test_torch_detector.py`'s
    limits (boxes 1e-2 px, scores 1e-3, after matching rows)."""
    cfg, jm, _, port = tiny_pair(seed=5)
    state = TrainState(port, make_optimizer(port.cfg.train, port), 6, 3)
    path = str(tmp_path / "epoch_2.pth")
    save_checkpoint(path, state)
    sd = load_torch_checkpoint(path)
    assert set(sd) == set(port.state_dict())
    variables = jckpt.load_torch_checkpoint(path, cfg)
    model = init_detector(port.cfg, checkpoint=path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k

    img = np.random.RandomState(6).normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    shapes = np.array([[60.0, 90.0]], np.float32)
    sf = np.array([[1.1, 1.2, 1.1, 1.2]], np.float32)
    jd = jax.jit(jm.apply)(variables, jnp.asarray(img), jnp.asarray(shapes), jnp.asarray(sf))
    with torch.no_grad():
        pd = model.simple_test(t(img), t(shapes), t(sf))
    jv, pv = np.asarray(jd.valid[0]), pd.valid[0].numpy()
    assert jv.sum() == pv.sum() > 0
    _assert_rows_match_or_tie(
        np.asarray(jd.boxes[0])[jv], np.asarray(jd.scores[0])[jv],
        pd.boxes[0].numpy()[pv], pd.scores[0].numpy()[pv],
        np.asarray(jd.labels[0])[jv], pd.labels[0].numpy()[pv], box_tol=1e-2)


def test_load_torch_checkpoint_of_mmdet_layouts(tmp_path):
    """An mmdet file with "state_dict" and one holding the dict itself give
    the same dict, without BatchNorm's `num_batches_tracked`."""
    sd = {"backbone.bn1.weight": torch.ones(4),
          "backbone.bn1.num_batches_tracked": torch.tensor(7)}
    torch.save({"meta": {}, "state_dict": sd}, tmp_path / "a.pth")
    torch.save(sd, tmp_path / "b.pth")
    for name in ("a.pth", "b.pth"):
        got = load_torch_checkpoint(str(tmp_path / name))
        assert list(got) == ["backbone.bn1.weight"] and torch.equal(got["backbone.bn1.weight"],
                                                                    torch.ones(4))
