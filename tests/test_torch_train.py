"""The training slice: the port's losses, assignment and sampling, the
training forward with its gradients, the SGD step and its schedule, and
the train step, against the JAX package on the tiny config (float32, CPU).

Both packages get the same weights (`tiny_pair`) and, through the
`overrides` hook of `forward_train`, the same sampled anchors, proposals
and rois, so that loss terms and gradients compare directly.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from htd_tpu import config as JC
from htd_tpu.models.layers import FrozenBatchNorm as JFrozenBN
from htd_tpu.ops.anchors import anchor_inside_flags as j_inside
from htd_tpu.train import losses as JL
from htd_tpu.train import optim as JO
from htd_tpu.train import sampling as JS
from htd_tpu_torch.models.layers import FrozenBatchNorm2d
from htd_tpu_torch.ops.anchors import anchor_inside_flags
from htd_tpu_torch.train import losses as PL
from htd_tpu_torch.train import optim as PO
from htd_tpu_torch.train import sampling as PS
from htd_tpu_torch.train.train_step import TrainBatch, create_train_state, train_step
from htd_tpu_torch.weights import state_dict_from_flax
from tests.torch_port import port_config, t, tiny_pair
from tests.tiny import tiny_config

torch.set_num_threads(1)
B, H, W = 2, 64, 96
IMG_SHAPES = np.array([[60.0, 90.0], [64.0, 80.0]], np.float32)
N_GT = 3
LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_bbox", "loss_global", "s0.loss_cls",
             "s0.loss_bbox", "s1.loss_cls", "s1.loss_bbox")


def _gts(rng, max_gt):
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.zeros((B, max_gt), np.int32)
    valid = np.zeros((B, max_gt), bool)
    for i in range(B):
        h, w = IMG_SHAPES[i]
        for g, (lo, hi) in enumerate([(10, 24), (20, 40), (40, 60)][:N_GT]):
            bw, bh = rng.uniform(lo, hi, 2)
            x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            boxes[i, g] = [x1, y1, x1 + bw, y1 + bh]
            labels[i, g] = rng.randint(0, 80)
            valid[i, g] = True
    return boxes, labels, valid


def _proposals(rng, n):
    """Boxes whose sqrt(area) keeps 4 px away from the level boundaries 56
    and 112, so that both packages map them to the same level."""
    out = np.zeros((B, n, 4), np.float32)
    for i in range(B):
        h, w = IMG_SHAPES[i]
        k = 0
        while k < n:
            bw, bh = rng.uniform(6, [w * 0.95, h * 0.95])
            if min(abs(np.sqrt(bw * bh) - 56), abs(np.sqrt(bw * bh) - 112)) > 4:
                x1, y1 = rng.uniform(-2, [w - bw + 2, h - bh + 2])
                out[i, k] = [x1, y1, x1 + bw, y1 + bh]
                k += 1
    return out


def _block(rng, num, pos_cap, n_cand, max_gt, n_pos_extra, n_neg):
    """One stage's injected (B, num) sample over concat([gt, candidates]):
    the gts and `n_pos_extra` candidates as positives first, then `n_neg`
    candidate negatives; the remaining slots invalid."""
    arrs = {k: np.zeros((B, num), d) for k, d in
            (("idx", np.int32), ("valid", bool), ("is_pos", bool), ("is_gt", bool),
             ("gt_inds", np.int32))}
    for i in range(B):
        cand = rng.permutation(n_cand)[:n_pos_extra + n_neg] + max_gt
        pos = list(range(N_GT)) + list(cand[:n_pos_extra])
        assert len(pos) <= pos_cap
        rows = pos + list(cand[n_pos_extra:])
        arrs["idx"][i, :len(rows)] = rows
        arrs["valid"][i, :len(rows)] = True
        arrs["is_pos"][i, :len(pos)] = True
        arrs["is_gt"][i, :N_GT] = True
        arrs["gt_inds"][i, :N_GT] = np.arange(N_GT)
        arrs["gt_inds"][i, N_GT:len(pos)] = rng.randint(0, N_GT, n_pos_extra)
    return arrs


def _overrides(seed, cfg, n_anchors):
    rng = np.random.RandomState(seed)
    tc = cfg.train
    ov = {}
    keep_pos = np.zeros((B, n_anchors), bool)
    keep_neg = np.zeros((B, n_anchors), bool)
    for i in range(B):
        perm = rng.permutation(n_anchors)
        keep_pos[i, perm[:6]] = True
        keep_neg[i, perm[6:26]] = True
    ov["rpn_keep_pos"], ov["rpn_keep_neg"] = keep_pos, keep_neg
    ov["rpn_matched_gt"] = rng.randint(0, N_GT, (B, n_anchors)).astype(np.int32)
    n_prop = tc.rpn_proposal.nms_post
    ov["proposals"] = _proposals(rng, n_prop)
    ov["proposal_valid"] = rng.uniform(size=(B, n_prop)) < 0.9
    num, pos_cap = tc.rcnn[0].sampler.num, tc.rcnn_pos_cap
    for s, n_cand, extra, neg in (("s0", n_prop, 3, 20), ("s1", num, 2, 18)):
        for k, v in _block(rng, num, pos_cap, n_cand if s == "s0" else 26, tc.max_gt,
                           extra, neg).items():
            ov[f"{s}_{k}"] = v
    return ov


def run_forward_train(seed=3, **overrides):
    """Loss terms and gradients of both packages' `forward_train` on the
    same injected samples, for `tiny_pair(seed, **overrides)`."""
    cfg, jm, variables, port = tiny_pair(seed=seed, **overrides)
    rng = np.random.RandomState(4)
    images = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    gt_boxes, gt_labels, gt_valid = _gts(rng, cfg.train.max_gt)
    n_anchors = 3 * sum((H // s) * (W // s) if s < 64 else 2 for s in (4, 8, 16, 32, 64))
    ov = _overrides(5, cfg, n_anchors)
    inputs = (images, IMG_SHAPES, gt_boxes, gt_labels, gt_valid)

    def total(params):
        losses = jm.apply(dict(variables, params=params), *map(jnp.asarray, inputs),
                          overrides={k: jnp.asarray(v) for k, v in ov.items()},
                          method=jm.forward_train, rngs={"sampling": jax.random.PRNGKey(0)})
        return sum(v for k, v in losses.items() if "loss" in k), losses

    (_, j_losses), j_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        variables["params"])
    p_losses = port.forward_train(*map(t, inputs), overrides={k: t(v) for k, v in ov.items()})
    sum(v for k, v in p_losses.items() if "loss" in k).backward()
    return cfg, variables, port, j_losses, j_grads, p_losses


def loss_term_failures(port, j_losses, p_losses):
    """Loss terms (and both accuracies) beyond 1e-4 relative."""
    assert tuple(p_losses) == port.loss_keys()
    failures = []
    for k in LOSS_KEYS + ("s0.acc", "s1.acc"):
        pv, jv = float(p_losses[k].detach()), float(j_losses[k])
        if abs(pv - jv) > 1e-4 * max(abs(jv), 1e-3):
            failures.append(f"{k}: port {pv} vs jax {jv}")
    return failures


def gradient_failures(port, variables, j_grads):
    """Parameters whose gradient, against the JAX tree mapped by
    `state_dict_from_flax`, is beyond tests/test_train_parity.py's ladder
    (backbone 2e-2, neck 1e-2, heads 5e-3 of the leaf's largest value);
    every parameter must have a gradient."""
    mapped = state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, j_grads),
         "batch_stats": variables["batch_stats"]}, port.cfg)
    params = dict(port.named_parameters())
    assert set(params) <= set(mapped)
    scale = max(float(p.grad.abs().max()) for p in params.values())
    failures = []
    for name, p in params.items():
        assert p.grad is not None, f"{name} got no gradient"
        ours, ref = p.grad.double().numpy(), mapped[name].double().numpy()
        denom = max(np.abs(ours).max(), np.abs(ref).max())
        if denom <= 1e-9 * max(scale, 1.0):
            continue
        tol = 2e-2 if name.startswith("backbone.") else 1e-2 if name.startswith("neck.") else 5e-3
        err = np.abs(ours - ref).max() / denom
        if err > tol:
            failures.append(f"{name} rel {err:.2e}")
    return failures


@pytest.fixture(scope="module")
def trained():
    return run_forward_train()


def test_forward_train_loss_terms_match(trained):
    """Every loss term (and both accuracies) within 1e-4 relative."""
    cfg, _, port, j_losses, _, p_losses = trained
    failures = loss_term_failures(port, j_losses, p_losses)
    assert not failures, "; ".join(failures)
    assert float(p_losses["s0.loss_bbox"].detach()) > 0
    assert float(p_losses["s1.loss_bbox"].detach()) > 0


def test_forward_train_gradients_match(trained):
    """The gradient of every parameter, the JAX tree mapped by
    `state_dict_from_flax`, within tests/test_train_parity.py's ladder
    (backbone 2e-2, neck 1e-2, heads 5e-3 of the leaf's largest value)."""
    cfg, variables, port, _, j_grads, _ = trained
    failures = gradient_failures(port, variables, j_grads)
    assert not failures, "; ".join(failures)
    # the BN affine parameters of layer2+ are trained, and get gradients
    params = dict(port.named_parameters())
    assert float(params["backbone.layer2.0.bn1.weight"].grad.abs().max()) > 0


@pytest.mark.parametrize("name", ["smooth_l1", "softmax_ce", "sigmoid_bce",
                                  "smooth_l1_loss", "multilabel_bce", "accuracy"])
def test_loss_functions_match(name, rng):
    """Each loss function against the JAX package's, to float32 rounding
    (1e-6 relative), with the max(avg_factor, 1) divisor exercised."""
    x = rng.normal(0, 2, (6, 9)).astype(np.float32)
    y = rng.normal(0, 2, (6, 9)).astype(np.float32)
    w = (rng.uniform(size=(6, 9)) < 0.7).astype(np.float32)
    labels = rng.randint(0, 9, 6).astype(np.int32)
    lw = (rng.uniform(size=6) < 0.6).astype(np.float32)
    tgt = (rng.uniform(size=(6, 9)) < 0.3).astype(np.float32)
    args = {
        "smooth_l1": lambda L: (L.smooth_l1, (x, y, 0.5)),
        "softmax_ce": lambda L: (L.softmax_ce, (x, labels, lw, np.float32(0.5))),
        "sigmoid_bce": lambda L: (L.sigmoid_bce, (x, tgt, w, np.float32(w.sum()))),
        "smooth_l1_loss": lambda L: (L.smooth_l1_loss, (x, y, w, 1.0 / 9.0, np.float32(7.0))),
        "multilabel_bce": lambda L: (L.multilabel_bce, (x, tgt, 3.0)),
        "accuracy": lambda L: (L.accuracy, (x, labels, lw)),
    }[name]
    jf, jargs = args(JL)
    pf, pargs = args(PL)
    ref = np.asarray(jf(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in jargs]))
    ours = pf(*[t(a) if isinstance(a, np.ndarray) else a for a in pargs]).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def _assign_case(rng):
    """Boxes and gts with ties: two identical gts, duplicated boxes, an
    invalid gt that overlaps everything and invalid boxes."""
    gts = np.array([[10, 10, 40, 40], [10, 10, 40, 40], [50, 20, 90, 70],
                    [0, 0, 100, 100], [60, 60, 64, 64]], np.float32)
    gt_valid = np.array([True, True, True, False, True])
    gt_labels = np.array([3, 7, 11, 13, 17], np.int32)
    xy = rng.uniform(0, 80, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (40, 2))], 1).astype(np.float32)
    boxes[5] = boxes[6] = [12, 12, 42, 40]        # the same near-copy of gt 0/1, twice
    boxes[7] = [50, 20, 90, 70]                   # exactly gt 2
    boxes[8] = [60.5, 60.5, 64.5, 64.5]           # the small gt's best box
    box_valid = rng.uniform(size=40) < 0.85
    box_valid[5:9] = True
    return boxes, box_valid, gts, gt_valid, gt_labels


@pytest.mark.parametrize("assigner", [(0.7, 0.3, 0.3, True), (0.5, 0.5, 0.5, False),
                                      (0.6, 0.4, 0.1, True)])
def test_assign_max_iou_matches(assigner, rng):
    """assign_max_iou: first gt on argmax ties, low-quality matches with
    ties included and later gts overriding earlier ones, invalid gts and
    boxes ignored: bit for bit the JAX package's."""
    boxes, box_valid, gts, gt_valid, gt_labels = _assign_case(rng)
    ref = JS.assign_max_iou(*map(jnp.asarray, (boxes, box_valid, gts, gt_valid, gt_labels)),
                            JC.AssignerConfig(*assigner))
    ours = PS.assign_max_iou(*map(t, (boxes, box_valid, gts, gt_valid, gt_labels)),
                             port_config(JC.AssignerConfig(*assigner)))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if assigner[3]:
        assert int(ours.gt_inds[5]) == 2 and int(ours.gt_inds[8]) == 5


def test_sample_from_injection_matches(rng):
    boxes, _, gts, _, gt_labels = _assign_case(rng)
    num = 16
    idx = rng.randint(0, len(boxes), num).astype(np.int32)
    valid = np.arange(num) < 12
    is_pos = np.arange(num) < 4
    is_gt = np.arange(num) < 2
    gt_inds = np.where(is_pos, rng.randint(0, len(gts), num), 7).astype(np.int32)
    gt_inds[~is_pos] = 0
    args = (boxes, gts, gt_labels, idx, valid, is_pos, is_gt, gt_inds)
    ref = JS.sample_from_injection(*map(jnp.asarray, args), 80)
    ours = PS.sample_from_injection(*map(t, args), 80)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("add_gt", [True, False])
def test_sample_random_invariants(add_gt, rng):
    """sample_random: the JAX package's counts (they do not depend on the
    draws); positives first; labels, matched gt boxes and is_gt consistent
    with the assignment; negatives below the negative threshold."""
    boxes, box_valid, gts, gt_valid, gt_labels = _assign_case(rng)
    acfg = JC.AssignerConfig(0.5, 0.5, 0.5, False)
    scfg = JC.SamplerConfig(24, 0.25, add_gt)
    ref = JS.sample_random(jax.random.PRNGKey(1), *map(jnp.asarray, (
        boxes, box_valid, gts, gt_valid, gt_labels)), acfg, scfg, 6, 80)
    gen = torch.Generator().manual_seed(1)
    s = PS.sample_random(*map(t, (boxes, box_valid, gts, gt_valid, gt_labels)),
                         port_config(acfg), port_config(scfg), 6, 80, generator=gen)
    npos = int(s.is_pos.sum())
    assert npos == int(np.asarray(ref.is_pos).sum()) and 0 < npos <= 6
    assert int(s.valid.sum()) == int(np.asarray(ref.valid).sum())
    assert s.is_pos[:npos].all() and not s.is_pos[npos:].any()
    assert s.valid[:int(s.valid.sum())].all()
    from htd_tpu_torch.ops.boxes import bbox_overlaps
    gtt, labt = t(gts), t(gt_labels).long()
    for k in range(24):
        if s.is_pos[k]:
            assert int(s.labels[k]) == int(labt[s.gt_inds[k]])
            assert torch.equal(s.pos_gt_boxes[k], gtt[s.gt_inds[k]])
            iou = bbox_overlaps(s.rois[k:k + 1], gtt[s.gt_inds[k]][None])[0, 0]
            assert bool(s.is_gt[k]) or float(iou) >= 0.5
            assert not s.is_gt[k] or torch.equal(s.rois[k], gtt[s.gt_inds[k]])
        else:
            assert int(s.labels[k]) == 80 and not s.pos_gt_boxes[k].any()
            if s.valid[k]:
                iou = bbox_overlaps(s.rois[k:k + 1], gtt[t(gt_valid)])
                assert float(iou.max()) < 0.5
    assert add_gt or not s.is_gt.any()


def test_anchor_inside_flags_matches(rng):
    anchors = rng.uniform(-20, 120, (200, 2)).astype(np.float32)
    anchors = np.concatenate([anchors, anchors + rng.uniform(1, 60, (200, 2))], 1)
    anchors = anchors.astype(np.float32)
    vf = rng.uniform(size=200) < 0.8
    for border in (0.0, 5.0, -1.0):
        ref = j_inside(jnp.asarray(anchors), jnp.asarray(vf), (70.0, 90.0), border)
        ours = anchor_inside_flags(t(anchors), t(vf), torch.tensor([70.0, 90.0]), border)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _sched_cfg():
    """A schedule whose three first steps are: warmup, across the first
    lr_steps boundary, across the second."""
    return dataclasses.replace(JC.TrainConfig(), warmup_iters=2, lr_steps=(1, 2))


def test_lr_schedule_matches():
    for cfg, spe in ((JC.TrainConfig(), 7330), (_sched_cfg(), 1)):
        ref = JO.lr_schedule(cfg, spe)
        ours = PO.lr_schedule(port_config(cfg), spe)
        for step in (0, 1, 2, 3, 250, 499, 500, 501, 8 * 7330 - 1, 8 * 7330, 11 * 7330):
            assert np.float32(ours(step)) == np.asarray(ref(step), np.float32), step


def test_sgd_steps_match_optax():
    """Three SGD steps on the same gradients (a warmup step, then steps
    across both lr_steps boundaries) against optax's chain: the updated
    parameters agree to float32 rounding, and the stem and layer1 do not
    move in either package."""
    cfg, _, variables, port = tiny_pair(seed=3)
    jcfg = _sched_cfg()
    tx = JO.make_optimizer(jcfg, variables["params"], 1)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    opt = PO.make_optimizer(port_config(jcfg), port)
    sched = PO.lr_schedule(port_config(jcfg), 1)
    frozen = {n for n, p in port.named_parameters() if not p.requires_grad}
    assert frozen == {n for n in frozen if n.startswith(
        ("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))} and frozen
    before = {k: v.clone() for k, v in port.state_dict().items()}
    rng = np.random.RandomState(7)
    update = jax.jit(lambda g, st, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *tx.update(g, st, p)))
    for step in range(3):
        pool = rng.normal(0, 1, 65537).astype(np.float32)
        grads = jax.tree_util.tree_map(lambda a: np.resize(pool, a.shape), variables["params"])
        params, opt_state = update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state,
                                   params)
        mapped = state_dict_from_flax({"params": grads, "batch_stats": variables["batch_stats"]},
                                      port.cfg)
        for name, p in port.named_parameters():
            p.grad = mapped[name].clone() if p.requires_grad else None
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
    ref = state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, params),
                                "batch_stats": variables["batch_stats"]}, port.cfg)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        assert torch.equal(p.detach(), before[name]) == (name in frozen), name


def test_frozen_batchnorm_affine_is_trainable(rng):
    """FrozenBatchNorm2d: `weight`/`bias` are parameters and the running
    statistics buffers, under BatchNorm2d's state-dict keys; its output is
    the JAX FrozenBatchNorm's, and gradients reach the affine parameters."""
    bn = FrozenBatchNorm2d(6)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean", "running_var"]
    assert [n for n, _ in bn.named_parameters()] == ["weight", "bias"]
    assert [n for n, _ in bn.named_buffers()] == ["running_mean", "running_var"]
    vals = {"weight": rng.normal(1, 0.1, 6), "bias": rng.normal(0, 0.1, 6),
            "running_mean": rng.normal(0, 0.1, 6), "running_var": rng.uniform(0.5, 2, 6),
            "num_batches_tracked": np.array(3)}
    bn.load_state_dict({k: torch.tensor(v, dtype=torch.float32 if v.ndim else torch.int64)
                        for k, v in vals.items()})
    x = rng.normal(0, 1, (2, 5, 7, 6)).astype(np.float32)
    ref = JFrozenBN(6).apply(
        {"params": {"scale": vals["weight"], "bias": vals["bias"]},
         "batch_stats": {"mean": vals["running_mean"], "var": vals["running_var"]}},
        jnp.asarray(x))
    out = bn(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    out.sum().backward()
    assert bn.weight.grad is not None and bn.bias.grad is not None
    with torch.inference_mode():
        assert torch.equal(bn(t(x).permute(0, 3, 1, 2)), out.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_cpu(dtype, rng):
    """create_train_state / train_step on the CPU: finite losses, the stem
    and layer1 bit-unchanged, layer2+ (a BN weight included) and the heads
    changed, float32 parameters; in bfloat16 the kernels' plain versions
    see bfloat16 features under autocast while the losses stay float32."""
    cfg = port_config(tiny_config(compute_dtype=dtype))
    state = create_train_state(cfg, device="cpu", seed=0)
    images = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    gts = _gts(rng, cfg.train.max_gt)
    batch = TrainBatch(t(images), t(IMG_SHAPES), *map(t, gts))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    seen = []
    hook = state.model.roi_head.bbox_roi_extractor[1].register_forward_hook(
        lambda m, args, out: seen.append(args[0].buf.dtype))
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        metrics = train_step(state, batch, gen)
        assert set(metrics) == set(state.model.loss_keys()) | {"loss"}
        assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in metrics.values())
    hook.remove()
    assert state.step == 2 and seen == [getattr(torch, dtype)] * 2
    after = state.model.state_dict()
    for k in before:
        if k.startswith(("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")) \
                or "running_" in k:
            assert torch.equal(before[k], after[k]), k
    for k in ("backbone.layer2.0.bn1.weight", "backbone.layer3.0.conv2.weight",
              "neck.fpn_convs.0.conv.weight", "rpn_head.rpn_conv.weight",
              "roi_head.bbox_head.1.fc_cls.weight", "roi_head.glbctx_head.fc.weight"):
        assert not torch.equal(before[k], after[k]), k
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_create_train_state_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(port_config(tiny_config()))
