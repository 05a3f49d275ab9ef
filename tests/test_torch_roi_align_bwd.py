"""Port parity for K4's function, RoIAlign's feature gradient, and for the
pyramid pack's backward.

On the CPU the port's RoIAlign backward is K4's plain version
(`roi_align_backward_plain`, and autograd of the plain forward); these
tests hold it to the JAX package's corner-folded scatters
(`roi_align_pyramid_batched_grad_feats`, `levels_pyramid_grad_feats`),
to `jax.vjp` of its gather forwards, and to its Pallas backward kernel
run in interpret mode. The CUDA kernel itself is held to the plain version
by tests/test_torch_cuda.py and chip_smoke.py on the card. The numpy
model of K4's fold (`fold_backward`, tests/test_torch_roi_align.py) is
held to the plain version here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import htd_tpu.ops.roi_align_pallas as rap
from htd_tpu.ops.boxes import map_roi_levels as jmap
from htd_tpu.ops.roi_align import levels_pyramid_grad_feats as j_levels_grad
from htd_tpu.ops.roi_align import roi_align_pyramid_batched as j_align
from htd_tpu.ops.roi_align import roi_align_pyramid_batched_grad_feats as j_grad
from htd_tpu_torch.ops import roi_align as pra
from htd_tpu_torch.ops import roi_align_cuda
from htd_tpu_torch.ops.pyramid import pack_pyramid, pyramid_level_grads
from htd_tpu_torch.ops.roi_align import (roi_align_backward_plain, roi_align_levels,
                                         roi_align_plain, roi_align_pyramid)
from tests.roi_cases import special_rois
from tests.test_torch_roi_align import fold_backward
from tests.torch_port import t

torch.set_num_threads(1)
STRIDES = (4, 8, 16, 32)
B, C, OUT = 2, 16, 7
H0, W0 = 32, 48                     # P2 of a 128 x 192 image


def _rois(rng, r, crowded=False):
    """Small and large rois, zero-area padding rois, rois crossing or on
    the image border, and (crowded) many rois around one positive."""
    img_h, img_w = 4.0 * H0, 4.0 * W0
    out = np.zeros((B, r, 4), np.float32)
    for i in range(B):
        xy = rng.uniform(-8, [img_w * 0.8, img_h * 0.8], (r, 2))
        wh = rng.uniform(2, [img_w * 0.9, img_h * 0.9], (r, 2))
        out[i] = np.concatenate([xy, xy + wh], 1)
        out[i, 0] = [-12, -9, img_w + 14, img_h + 6]        # crosses every border
        out[i, 1] = [0, 0, 40, img_h]                       # on the border
        out[i, 2] = [img_w - 30, img_h - 25, img_w, img_h]  # the far corner
        out[i, -3:] = 0.0                                   # zero-area padding
        if crowded:
            base = np.array([40.0, 30.0, 96.0, 90.0], np.float32)
            out[i, 3:3 + r // 2] = base + rng.uniform(-6, 6, (r // 2, 4))
    return out


def _case(seed, r=20, crowded=False, all_levels=False):
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1, (B, H0 >> q, W0 >> q, C)).astype(np.float32) for q in range(4)]
    rois = _rois(rng, r, crowded)
    lead = (4, B, r) if all_levels else (B, r)
    g = rng.normal(0, 1, lead + (OUT, OUT, C)).astype(np.float32)
    lvls = np.asarray(jax.vmap(lambda x: jmap(jnp.asarray(x), 4))(rois))
    return feats, rois, lvls, g


def _port_grads(feats, rois, lvls, g, s):
    geom = pack_pyramid([t(f) for f in feats]).geom
    d = roi_align_backward_plain(geom, t(rois), None if lvls is None else t(lvls), t(g),
                                 STRIDES, OUT, 0, s)
    assert d.dtype == torch.float32 and d.shape == (geom.rows_pad, geom.w_pad, C)
    return [x.numpy() for x in pyramid_level_grads(d, geom)]


def _assert_close(ours, ref, tol=1e-5):
    for lvl, (a, b) in enumerate(zip(ours, ref)):
        b = np.asarray(b, np.float64)
        assert a.shape == b.shape
        err = np.abs(a.astype(np.float64) - b).max() / max(np.abs(b).max(), 1e-6)
        assert err <= tol, f"level {lvl}: rel err {err:.2e}"


@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("s", [4, 2, 1])
def test_level_mapped_matches_jax(s, crowded):
    """K4's plain version, level-mapped, against the JAX corner-folded
    scatter and against jax.vjp of the gather forward: within 1e-5 of the
    largest gradient (float32 sums in another order)."""
    feats, rois, lvls, g = _case(1 + s + 10 * crowded, crowded=crowded)
    ours = _port_grads(feats, rois, lvls, g, s)
    fj, rj, lj = [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(lvls)
    _assert_close(ours, j_grad(fj, rj, STRIDES, lj, jnp.asarray(g), OUT, 0, s))
    _, vjp = jax.vjp(lambda fs: j_align(list(fs), rj, STRIDES, lj, OUT, 0, s), tuple(fj))
    _assert_close(ours, vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("s", [1, 2, 4])
def test_all_levels_matches_jax(s):
    """K4's plain version in the all-level mode (the BA pass) against the
    JAX `levels_pyramid_grad_feats` and jax.vjp of `_levels_pyramid_impl`."""
    feats, rois, _, g = _case(5 + s, crowded=True, all_levels=True)
    ours = _port_grads(feats, rois, None, g, s)
    geom = pack_pyramid([t(f) for f in feats]).geom
    fj, rj = [jnp.asarray(f) for f in feats], jnp.asarray(rois)
    gs = [jnp.asarray(x) for x in g]
    _assert_close(ours, j_levels_grad(fj, rj, STRIDES, gs, geom.w_pad, list(geom.row_offsets),
                                      geom.img_rows, OUT, 0, s))
    _, vjp = jax.vjp(lambda fs: tuple(rap._levels_pyramid_impl(list(fs), rj, STRIDES, OUT, 0, s)),
                     tuple(fj))
    _assert_close(ours, vjp(tuple(gs))[0])


def test_pallas_backward_interpret_matches_plain(monkeypatch):
    """The TPU kernel `roi_align_pallas_v4_bwd` run in interpret mode, with
    a fallback cap large enough for every overflowing roi, against K4's
    plain version (crowded rois overflow the kernel's 16 slots)."""
    monkeypatch.setattr(rap, "_FORCE_KERNEL_INTERPRET", True)
    monkeypatch.setenv("HTD_RA_BWD_FB", "64")
    feats, rois, lvls, g = _case(3, r=16, crowded=True)
    ours = _port_grads(feats, rois, lvls, g, 4)
    ref = rap.roi_align_fused_batched_grad_feats(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES, jnp.asarray(lvls),
        jnp.asarray(g), out_size=OUT, max_samples=4, interpret=True)
    _assert_close(ours, ref, tol=2e-5)


def test_pyramid_backward_matches_jax():
    """pack_pyramid's autograd hands each level its window of the pyramid
    gradient, bit for bit the JAX package's `_pyr_build_bwd`."""
    rng = np.random.RandomState(2)
    feats = [t(rng.normal(0, 1, (B, H0 >> q, W0 >> q, C)).astype(np.float32))
             .requires_grad_(True) for q in range(4)]
    pyr = pack_pyramid(feats)
    geom = pyr.geom
    gp = rng.normal(0, 1, tuple(pyr.buf.shape)).astype(np.float32)
    (pyr.buf * t(gp)).sum().backward()
    ref = rap._pyr_build_bwd(geom.row_offsets, geom.img_rows, geom.rows_pad, geom.w_pad, True,
                             False, tuple(tuple(f.shape) for f in feats), jnp.asarray(gp))[0]
    for f, r in zip(feats, ref):
        assert f.grad.is_contiguous()
        np.testing.assert_array_equal(f.grad.numpy(), np.asarray(r))


@pytest.mark.parametrize("all_levels", [False, True])
def test_plain_autograd_is_backward_plain(all_levels):
    """On CPU tensors the wrappers' autograd (through pack_pyramid and the
    plain forward) gives the levels the gradient of `roi_align_backward_plain`."""
    feats, rois, lvls, g = _case(4, all_levels=all_levels)
    levels = [t(f).requires_grad_(True) for f in feats]
    pyr = pack_pyramid(levels)
    s = 1 if all_levels else 4
    if all_levels:
        out = roi_align_levels(pyr, t(rois), STRIDES, OUT, 0, s)
    else:
        out = roi_align_pyramid(pyr, t(rois), t(lvls), STRIDES, OUT, 0, s)
    out.backward(t(g))
    ours = _port_grads(feats, rois, None if all_levels else lvls, g, s)
    _assert_close(ours, [f.grad.numpy() for f in levels], tol=1e-6)


def test_cuda_autograd_function_wiring(monkeypatch):
    """The autograd function that the wrappers use on CUDA tensors (K2
    forward, K4 backward), run on the CPU with the two launchers replaced
    by their plain versions: its gradient reaches the levels as autograd
    of the plain forward does, and None reaches rois and levels."""
    monkeypatch.setattr(roi_align_cuda, "launch_roi_align",
                        lambda pyr, rois, lv, *a: roi_align_plain(pyr, rois, lv, *a))
    monkeypatch.setattr(roi_align_cuda, "launch_roi_align_bwd", roi_align_backward_plain)
    feats, rois, lvls, g = _case(6)
    levels = [t(f).requires_grad_(True) for f in feats]
    pyr = pack_pyramid(levels)
    out = pra._RoIAlign.apply(pyr.buf, pyr.geom, t(rois), t(lvls), STRIDES, OUT, 0, 4)
    out.backward(t(g))
    ref_levels = [t(f).requires_grad_(True) for f in feats]
    roi_align_plain(pack_pyramid(ref_levels), t(rois), t(lvls), STRIDES, OUT, 0, 4).backward(t(g))
    _assert_close([f.grad.numpy() for f in levels], [f.grad.numpy() for f in ref_levels],
                  tol=1e-6)


def _special_case(seed, all_levels=False, r=14):
    """`special_rois` (sub-pixel bins on P2, samples in [-1, 0) and
    (size - 1, size], a roi wider than every level, zero width and height)
    with a cotangent that has all-zero bins: one roi's whole cotangent, two
    bin rows of another, one bin of every roi."""
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1, (B, H0 >> q, W0 >> q, C)).astype(np.float32) for q in range(4)]
    rois = special_rois(rng, B, r, 4.0 * H0, 4.0 * W0)
    lead = (4, B, r) if all_levels else (B, r)
    g = rng.normal(0, 1, lead + (OUT, OUT, C)).astype(np.float32)
    g[..., 8, :, :, :] = 0.0
    g[..., 9, 2:4, :, :] = 0.0
    g[..., 5, 1, :] = 0.0
    lvls = np.array(jax.vmap(lambda x: jmap(jnp.asarray(x), 4))(rois))
    return feats, rois, lvls, g


@pytest.mark.parametrize("all_levels", [False, True])
@pytest.mark.parametrize("s", [4, 2, 1])
def test_special_rois_match_jax(s, all_levels):
    """K4's plain version on `_special_case`, level-mapped against the JAX
    corner-folded scatter and every roi on every level against
    `levels_pyramid_grad_feats`: within 1e-5 of the largest gradient."""
    feats, rois, lvls, g = _special_case(20 + s, all_levels)
    ours = _port_grads(feats, rois, None if all_levels else lvls, g, s)
    fj, rj = [jnp.asarray(f) for f in feats], jnp.asarray(rois)
    if all_levels:
        geom = pack_pyramid([t(f) for f in feats]).geom
        ref = j_levels_grad(fj, rj, STRIDES, [jnp.asarray(x) for x in g], geom.w_pad,
                            list(geom.row_offsets), geom.img_rows, OUT, 0, s)
    else:
        ref = j_grad(fj, rj, STRIDES, jnp.asarray(lvls), jnp.asarray(g), OUT, 0, s)
    _assert_close(ours, ref)


@pytest.mark.parametrize("case", ["random", "crowded", "special", "inverted"])
@pytest.mark.parametrize("s", [4, 2, 1])
def test_fold_model_matches_backward_plain(s, case):
    """The numpy model of K4's fold (U = Wx . g / count per bin row, then one
    sum per distinct pixel of each roi) against `roi_align_backward_plain`,
    level-mapped and every roi on every level, within float32 rounding: 1e-5
    of the largest gradient. "inverted": the special rois with x2 < x1 and
    y2 < y1 under a fixed grid (sampling_ratio = s)."""
    sr = s if case == "inverted" else 0
    for all_levels in (False, True):
        if case in ("special", "inverted"):
            feats, rois, lvls, g = _special_case(30 + s, all_levels)
            if case == "inverted":
                rois = np.ascontiguousarray(rois[..., [2, 3, 0, 1]])
        else:
            feats, rois, lvls, g = _case(40 + s, r=12, crowded=case == "crowded",
                                         all_levels=all_levels)
        geom = pack_pyramid([t(f) for f in feats]).geom
        d = roi_align_backward_plain(geom, t(rois), None if all_levels else t(lvls), t(g),
                                     STRIDES, OUT, sr, s)
        ours = [x.numpy() for x in pyramid_level_grads(d, geom)]
        shapes = [f.shape[1:3] for f in feats]
        passes = ([(np.full(lvls.shape, q), g[q]) for q in range(4)] if all_levels
                  else [(lvls, g)])
        model = [np.zeros_like(f) for f in feats]
        for lv, gq in passes:
            for acc, dq in zip(model, fold_backward(shapes, rois, lv, gq, STRIDES, OUT, sr, s)):
                acc += dq
        _assert_close(ours, model)
