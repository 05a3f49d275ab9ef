"""Port parity: ResNet, FPN, RPN head and proposals (htd_tpu_torch vs
htd_tpu on the tiny config, float32, CPU). Weights come from the JAX
detector's variable tree through `state_dict_from_flax`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from htd_tpu.models.fpn import FPN as JFPN
from htd_tpu.models.resnet import ResNet as JResNet
from htd_tpu.models.rpn import RPNHead as JRPNHead, gen_proposals as j_gen_proposals
from htd_tpu.ops.anchors import AnchorGenerator as JAnchors
from htd_tpu_torch.models.rpn import gen_proposals
from tests.torch_port import t, tiny_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    cfg, _, variables, port = tiny_pair(seed=1)
    img = np.random.RandomState(2).normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    p, bs = variables["params"], variables["batch_stats"]
    c2_5 = jax.jit(JResNet(depth=10).apply)(
        {"params": p["backbone"], "batch_stats": bs["backbone"]}, jnp.asarray(img))
    levels = jax.jit(JFPN().apply)({"params": p["neck"]}, list(c2_5))
    with torch.no_grad():
        pc = [c.permute(0, 2, 3, 1) for c in port.backbone(t(img).permute(0, 3, 1, 2))]
        pl = port.extract_feats(t(img))
    return cfg, variables, port, (c2_5, levels), (pc, pl)


def _close(ours_nhwc, ref_nhwc, tol):
    ref = np.asarray(ref_nhwc)
    ours = ours_nhwc.numpy()
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, err


def test_resnet_matches(pair):
    """C2-C5 within 1e-4 relative (float32, different conv summation)."""
    _, _, _, (jc, _), (pc, _) = pair
    for a, b in zip(pc, jc):
        _close(a, b, 1e-4)


def test_fpn_matches(pair):
    """P2-P6 from `extract_feats` (NHWC) within 1e-4 relative."""
    _, _, _, (_, jl), (_, pl) = pair
    assert len(pl) == 5
    for a, b in zip(pl, jl):
        _close(a, b, 1e-4)


def test_rpn_and_proposals_match(pair):
    """RPN logits/deltas within 1e-4 relative; proposals: same count, and
    boxes <= 1e-3 px / scores <= 1e-5 after matching rows (sigmoid ties
    may reorder within a level)."""
    cfg, variables, port, (_, jl), (_, pl) = pair
    js, jd = jax.jit(JRPNHead().apply)({"params": variables["params"]["rpn_head"]}, list(jl))
    with torch.no_grad():
        ps, pd = port.rpn_head([f.permute(0, 3, 1, 2) for f in pl])
    for a, b in zip(ps + pd, list(js) + list(jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(b).max())))
    shapes = np.array([[60.0, 90.0]], np.float32)
    jb, jsc, jv = jax.jit(lambda s, d, sh: j_gen_proposals(s, d, JAnchors(), sh,
                                                           cfg.proposal_test))(
        js, jd, jnp.asarray(shapes))
    pb, psc, pv = gen_proposals(ps, pd, port.anchor_gen, t(shapes), port.cfg.proposal_test)
    assert pb.shape == (1, cfg.proposal_test.nms_post, 4)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    jb, jsc = np.asarray(jb[0])[np.asarray(jv[0])], np.asarray(jsc[0])[np.asarray(jv[0])]
    pb, psc = pb[0][pv[0]].numpy(), psc[0][pv[0]].numpy()
    np.testing.assert_allclose(np.sort(psc), np.sort(jsc), rtol=0, atol=1e-5)
    for box in pb:
        assert np.abs(jb - box).max(axis=1).min() <= 1e-3
