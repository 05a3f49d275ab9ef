"""Port parity for the two kernels' functions: the pyramid pack (K1) and
the level-mapped / all-level RoIAlign (K2).

On the CPU the port's wrappers run the kernels' plain versions; these are
held to the JAX package's XLA forms and to its Pallas kernels run in
interpret mode. The CUDA kernels themselves are held to the plain
versions by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import htd_tpu.ops.roi_align_pallas as rap
from htd_tpu.ops.boxes import map_roi_levels as jmap
from htd_tpu.ops.roi_align import roi_align_pyramid_batched as j_align
from htd_tpu_torch.ops.boxes import map_roi_levels
from htd_tpu_torch.ops.pyramid import pack_pyramid, pyramid_geometry
from htd_tpu_torch.ops.roi_align import (roi_align_levels, roi_align_pyramid,
                                         roi_align_pyramid_batched)
from tests.torch_port import t

torch.set_num_threads(1)
STRIDES = (4, 8, 16, 32)


def _levels(rng, b=2, h=64, w=96, c=8):
    return [rng.normal(0, 1, (b, h >> i, w >> i, c)).astype(np.float32)
            for i in range(4)]


def _rois(rng, b=2, r=24, h=64, w=96):
    """Rois of every kind the kernel must handle exactly: small and large,
    zero-area, crossing the image border, and elongated."""
    out = np.zeros((b, r, 4), np.float32)
    for i in range(b):
        xy = rng.uniform(-10, [w, h], (r, 2))
        wh = rng.uniform(1, 120, (r, 2))
        out[i] = np.concatenate([xy, xy + wh], 1)
        out[i, 0] = [10, 10, 10, 30]                 # zero width
        out[i, 1] = [5, 5, 5, 5]                     # zero area
        out[i, 2] = [-20, -15, w + 25, h + 10]       # crosses every border
        out[i, 3] = [2, 20, w - 2, 26]               # elongated
        out[i, 4] = [30, 1, 34, h - 1]               # elongated
    return out


def test_pyramid_plain_matches_jax(rng):
    """K1's plain version == the JAX XLA build and the Pallas kernel run in
    interpret mode, bit for bit in float32, geometry included."""
    for b, shapes in ((2, [(32, 48), (16, 24), (8, 12), (4, 6)]),
                      (1, [(12, 20), (6, 10)])):
        feats = [rng.normal(0, 1, (b, h, w, 8)).astype(np.float32) for h, w in shapes]
        geom = pyramid_geometry([f.shape for f in feats])
        ours = pack_pyramid([t(f) for f in feats])
        assert ours.geom == geom
        max_w = max(w for _, w in shapes)
        win_w = ((max_w - 1) // rap.V4_X_BLOCK + 2) * rap.V4_X_BLOCK - rap.V4_X_BLOCK
        jf = [jnp.asarray(f) for f in feats]
        for build in (rap._build_pyramid_xla, lambda *a: rap._build_pyramid_pallas(
                *a, interpret=True)):
            geo = build(jf, rap.V4_RES_H, win_w, rap.V4_X_BLOCK, rap.V4_Y_STRIPE)[1:]
            pyr = jax.jit(lambda fs: build(fs, rap.V4_RES_H, win_w, rap.V4_X_BLOCK,
                                           rap.V4_Y_STRIPE)[0])(jf)
            offs, w_pad, rows_pad, img_rows = geo
            assert (list(geom.row_offsets), geom.w_pad, geom.rows_pad, geom.img_rows) == (
                list(offs), w_pad, rows_pad, img_rows)
            np.testing.assert_array_equal(ours.buf.numpy(), np.asarray(pyr))


@pytest.mark.parametrize("max_samples", [4, 1])
def test_roi_align_plain_matches_jax(rng, max_samples):
    """K2's plain version == `roi_align_pyramid_batched` (XLA gather), B=2,
    with zero-area, border-crossing and elongated rois: <= 1e-5 abs."""
    feats = _levels(rng)
    rois = _rois(rng)
    lv = jax.vmap(lambda r: jmap(r, 4))(jnp.asarray(rois))
    # eager: jit lets XLA contract the sample geometry into FMAs, which
    # moves the reference by ~1e-5
    ref = j_align([jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES, lv,
                  7, 0, max_samples)
    plv = map_roi_levels(t(rois), 4)
    np.testing.assert_array_equal(plv.numpy(), np.asarray(lv))
    ours = roi_align_pyramid_batched([t(f) for f in feats], t(rois), STRIDES, plv, 7, 0,
                                     max_samples)
    assert ours.shape == (2, 24, 7, 7, 8)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert np.abs(ours[:, :2].numpy()).max() == 0.0  # zero-area rois give zeros


@pytest.mark.parametrize("max_samples", [4, 1])
def test_roi_align_plain_matches_pallas_interpret(rng, monkeypatch, max_samples):
    """K2's plain version == the TPU v4 kernel body (plus its fallback) run
    in Pallas interpret mode, B=2: <= 1e-5 abs."""
    monkeypatch.setattr(rap, "_FORCE_KERNEL_INTERPRET", True)
    feats = _levels(rng, b=2, h=16, w=24, c=8)
    rois = _rois(rng, b=2, r=8, h=16, w=24)
    lv = jax.vmap(lambda r: jmap(r, 4))(jnp.asarray(rois))
    ref = jax.jit(lambda fs, r, l: rap.roi_align_fused_batched(
        fs, r, STRIDES, l, 7, 0, max_samples, interpret=True, fallback_cap=20))(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), lv)
    ours = roi_align_pyramid_batched([t(f) for f in feats], t(rois), STRIDES,
                                     map_roi_levels(t(rois), 4), 7, 0, max_samples)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_roi_align_levels_matches_jax(rng):
    """The all-level pass (BA extractor) == `_levels_pyramid_impl` at the
    production clamp `adpt_max_samples` = 1 and at 2: <= 1e-5 abs."""
    feats = _levels(rng)
    rois = _rois(rng)
    pyr = pack_pyramid([t(f) for f in feats])
    for s in (1, 2):
        ref = rap._levels_pyramid_impl([jnp.asarray(f) for f in feats],
                                       jnp.asarray(rois), STRIDES, 7, 0, s)
        ours = roi_align_levels(pyr, t(rois), STRIDES, 7, 0, s)
        assert ours.shape == (4, 2, 24, 7, 7, 8)
        for lvl in range(4):
            np.testing.assert_allclose(ours[lvl].numpy(), np.asarray(ref[lvl]),
                                       rtol=0, atol=1e-5)


def test_wrappers_reject_bad_input(rng):
    feats = [t(f) for f in _levels(rng)]
    pyr = pack_pyramid(feats)
    with pytest.raises(ValueError):
        roi_align_pyramid(pyr, torch.zeros(3, 5, 4), torch.zeros(3, 5, dtype=torch.int32),
                          STRIDES)
    with pytest.raises(ValueError):
        pack_pyramid([feats[0], feats[1].double()])

