"""Port parity: SFA head, Shared2FC head, HTD head (PGraph + BA, all three
edge modes) and the BA extractor (htd_tpu_torch vs htd_tpu, tiny config,
float32, CPU). Weights come from the JAX detector's variable tree through
`state_dict_from_flax`; inputs are numpy draws from a seed."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from htd_tpu.models.heads import (GlobalContextHead as JGlobal, HTDBBoxHead as JHTDHead,
                                  Shared2FCBBoxHead as JShared2FC)
from htd_tpu.models.roi_extract import AdptRoIExtractor as JAdpt
from htd_tpu.ops.boxes import map_roi_levels as jmap
from htd_tpu_torch.models.heads import HTDBBoxHead
from htd_tpu_torch.ops.boxes import map_roi_levels
from htd_tpu_torch.ops.pyramid import pack_pyramid
from tests.torch_port import port_config, t, tiny_pair

torch.set_num_threads(1)
R = 12


@pytest.fixture(scope="module")
def pair():
    cfg, _, variables, port = tiny_pair(seed=3)
    return cfg, variables["params"], port


def _rois(rng, b=1, r=R, h=64, w=96):
    xy = rng.uniform(0, [w - 10, h - 10], (b, r, 2))
    wh = rng.uniform(4, 60, (b, r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _rel(ours, ref):
    ref = np.asarray(ref)
    return np.abs(ours.detach().numpy() - ref).max() / max(1.0, np.abs(ref).max())


def test_global_and_stage0_heads_match(pair, rng):
    """SFA logits/feature and Shared2FC cls/reg within 1e-4 relative."""
    cfg, p, port = pair
    top = rng.normal(0, 1, (2, 3, 4, 256)).astype(np.float32)
    jl, jf = jax.jit(JGlobal(cfg.global_ctx, 81).apply)({"params": p["glbctx_head"]},
                                                        jnp.asarray(top))
    with torch.no_grad():
        pl, pf = port.roi_head.glbctx_head(t(top).permute(0, 3, 1, 2))
    assert _rel(pl, jl) <= 1e-4 and _rel(pf, jf) <= 1e-4
    feats = rng.normal(0, 1, (2, R, 7, 7, 256)).astype(np.float32)
    jc, jr = jax.jit(JShared2FC().apply)({"params": p["stage0_head"]}, jnp.asarray(feats))
    with torch.no_grad():
        pc, pr = port.roi_head.bbox_head[0](t(feats))
    assert _rel(pc, jc) <= 1e-4 and _rel(pr, jr) <= 1e-4


@pytest.mark.parametrize("mode", ["add", "replace", "average"])
def test_htd_head_matches(pair, rng, mode):
    """PGraph cls + BA GN-conv reg, with padded rois and the global
    feature: cls and reg within 1e-4 relative, per edge mode."""
    cfg, p, port = pair
    hcfg = dataclasses.replace(cfg.stage1_head, replace_mode=mode == "replace",
                               average_mode=mode == "average")
    x_cls = rng.normal(0, 1, (2, R, 7, 7, 256)).astype(np.float32)
    enh = rng.normal(0, 1, (2, R, 7, 7, 256)).astype(np.float32)
    glb = rng.normal(0, 1, (2, 256)).astype(np.float32)
    rois = _rois(rng, b=2)
    valid = np.ones((2, R), bool)
    valid[1, -3:] = False
    k0, b0 = p["stage0_head"]["fc_cls_kernel"], p["stage0_head"]["fc_cls_bias"]
    jc, jr = jax.jit(JHTDHead(hcfg, num_levels=4).apply)(
        {"params": p["stage1_head"]}, jnp.asarray(x_cls), jnp.asarray(x_cls),
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(k0), jnp.asarray(b0),
        jnp.asarray(enh), jnp.asarray(glb))
    head = HTDBBoxHead(port_config(hcfg), num_levels=4)
    head.load_state_dict(port.roi_head.bbox_head[1].state_dict())
    w0, b0t = port.roi_head.bbox_head[0].cls_params()
    with torch.no_grad():
        pc, pr = head.eval()(t(x_cls), t(x_cls), t(rois), t(valid), w0, b0t, t(enh), t(glb))
    assert _rel(pc, jc) <= 1e-4
    assert _rel(pr, jr) <= 1e-4


def test_adpt_extractor_matches(pair, rng):
    """BA extractor on the packed pyramid, with and without the own-level
    replacement: within 1e-5 relative."""
    cfg, p, port = pair
    feats = [rng.normal(0, 1, (1, 64 >> i, 96 >> i, 256)).astype(np.float32)
             for i in range(2, 6)]
    rois = _rois(rng, h=256, w=384)
    tgt = rng.normal(0, 1, (1, R, 7, 7, 256)).astype(np.float32)
    jlv = jmap(jnp.asarray(rois), 4)
    ext = port.roi_head.bbox_roi_extractor[1]
    pyr = pack_pyramid([t(f) for f in feats])
    for with_target in (False, True):
        extra = (jnp.asarray(tgt), jlv) if with_target else ()
        ref = jax.jit(JAdpt(cfg.roi_extractor).apply)(
            {"params": p["adpt_extractor"]}, [jnp.asarray(f) for f in feats],
            jnp.asarray(rois), *extra)
        pextra = (t(tgt), map_roi_levels(t(rois), 4)) if with_target else ()
        with torch.no_grad():
            ours = ext(pyr, t(rois), *pextra)
        assert _rel(ours, ref) <= 1e-5
