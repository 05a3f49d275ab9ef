"""Port parity for the two kernels' functions: the pyramid pack (K1) and
the level-mapped / all-level RoIAlign (K2).

On the CPU the port's wrappers run the kernels' plain versions; these are
held to the JAX package's XLA forms and to its Pallas kernels run in
interpret mode. The CUDA kernels themselves are held to the plain
versions by tests/test_torch_cuda.py and chip_smoke.py on the card.

K2 and K4 fold each roi's samples into a separable contraction over the
roi's distinct corner rows and columns (csrc/roi_align_geom.cuh). A numpy
model of that fold (`fold_tables`, `fold_forward`, and `fold_backward`
for K4) is held here to the plain versions on the rois the fold must
handle (`tests/roi_cases.py::special_rois`), so that its math and de-duplication are checked
before the card.
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
from htd_tpu_torch.ops.roi_align import (_level_tables, _sample_geometry, roi_align_levels,
                                         roi_align_plain, roi_align_pyramid,
                                         roi_align_pyramid_batched)
from tests.roi_cases import special_rois
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


def fold_tables(low, high, w_low, w_high, asc=True):
    """One roi's fold on one axis. low, high: (out, S) corner indices;
    w_low, w_high: their weights, 0 for dead samples; asc: whether the
    sample coordinates increase (bin >= 0), else each sample's high corner
    comes first. Returns the distinct indices with a non-zero weight, in
    order of first appearance, and W (out, n): per
    bin, the sum of its corners' weights on each index (the kernels'
    `build_tables`). Asserts that the indices are sorted and that each
    bin's non-zero weights are a contiguous run of them."""
    o, s = low.shape

    def corners(p, i):
        c = ((int(low[p, i]), w_low[p, i]), (int(high[p, i]), w_high[p, i]))
        return c if asc else c[::-1]

    idx, slot = [], {}
    for p in range(o):
        for i in range(s):
            for v, w in corners(p, i):
                if w != 0 and v not in slot:
                    slot[v] = len(idx)
                    idx.append(v)
    wt = np.zeros((o, len(idx)), np.float32)
    for p in range(o):
        for i in range(s):
            for v, w in corners(p, i):
                if w != 0:
                    wt[p, slot[v]] += np.float32(w)
    # what the kernels rely on: sample coordinates are monotone, so the
    # distinct indices come out sorted and each bin reads a contiguous run
    # of them
    d = np.diff(idx)
    assert (d > 0).all() or (d < 0).all()
    for p in range(o):
        used = np.flatnonzero(wt[p])
        assert len(used) == 0 or (np.diff(used) == 1).all()
    return np.asarray(idx, np.int64), wt


def fold_rois(rois, lvls, shapes, strides, out, sampling_ratio, max_samples):
    """Per roi of (N, 4) rois on levels (N,): (iy, Wy, ix, Wx, count), the
    geometry from the plain version's `_sample_geometry`."""
    scale = np.array([1.0 / s for s in strides], np.float32)
    hs = np.array([h for h, _ in shapes], np.float32)
    ws = np.array([w for _, w in shapes], np.float32)
    lv = np.asarray(lvls, np.int64)
    (xl, xh, lx, hx, mx, xin, yl, yh, ly, hy, my, yin, gw, gh) = [
        a.numpy() for a in _sample_geometry(torch.from_numpy(np.asarray(rois, np.float32)),
                                            torch.from_numpy(scale[lv]), torch.from_numpy(hs[lv]),
                                            torch.from_numpy(ws[lv]), out, sampling_ratio,
                                            max_samples)]
    rois = np.asarray(rois, np.float32)
    tables = []
    for n in range(len(lv)):
        ly_live, lx_live = (my[n] & yin[n]), (mx[n] & xin[n])
        iy, wy = fold_tables(yl[n], yh[n], hy[n] * ly_live, ly[n] * ly_live,
                             rois[n, 3] >= rois[n, 1])
        ix, wx = fold_tables(xl[n], xh[n], hx[n] * lx_live, lx[n] * lx_live,
                             rois[n, 2] >= rois[n, 0])
        tables.append((iy, wy, ix, wx, np.float32(max(int(gh[n]) * int(gw[n]), 1))))
    return tables


def fold_forward(feats, rois, lvls, strides, out, sampling_ratio, max_samples):
    """The fold's RoIAlign: per-level (B, H, W, C) float32 maps, (B, R, 4)
    rois on levels (B, R) -> (B, R, out, out, C): an x-pass over each
    distinct row, then a y-pass, then / count."""
    b, r = rois.shape[:2]
    shapes = [f.shape[1:3] for f in feats]
    tables = fold_rois(rois.reshape(-1, 4), lvls.reshape(-1), shapes, strides, out,
                       sampling_ratio, max_samples)
    res = np.zeros((b * r, out, out, feats[0].shape[-1]), np.float32)
    for n, (iy, wy, ix, wx, count) in enumerate(tables):
        f = feats[int(lvls.reshape(-1)[n])][n // r]
        t_ = np.einsum("px,rxc->rpc", wx, f[np.ix_(iy, ix)])
        res[n] = np.einsum("hr,rpc->hpc", wy, t_) / count
    return res.reshape(b, r, out, out, -1)


def fold_backward(shapes, rois, lvls, g, strides, out, sampling_ratio, max_samples):
    """The transpose: the cotangent g (B, R, out, out, C) -> per-level
    float32 gradients (B, H, W, C); U = Wx . g / count per bin row, then
    one sum per distinct (row, column) pixel of each roi."""
    b, r = rois.shape[:2]
    c = g.shape[-1]
    d = [np.zeros((b, h, w, c), np.float32) for h, w in shapes]
    tables = fold_rois(rois.reshape(-1, 4), lvls.reshape(-1), shapes, strides, out,
                       sampling_ratio, max_samples)
    g = g.reshape(b * r, out, out, c).astype(np.float32)
    for n, (iy, wy, ix, wx, count) in enumerate(tables):
        u = np.einsum("px,hpc->hxc", wx, g[n] / count)
        d[int(lvls.reshape(-1)[n])][n // r][np.ix_(iy, ix)] += np.einsum("hr,hxc->rxc", wy, u)
    return d


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


@pytest.mark.parametrize("max_samples", [4, 2, 1])
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



def _special_case(seed, c=8, h=32, w=48):
    rng = np.random.RandomState(seed)
    feats = [rng.normal(0, 1, (2, h >> q, w >> q, c)).astype(np.float32) for q in range(4)]
    return feats, special_rois(rng, 2, 14, 4 * h, 4 * w)


@pytest.mark.parametrize("max_samples", [4, 2, 1])
def test_special_rois_match_jax(max_samples):
    """K2's plain version on `special_rois` (sub-pixel bins, samples in
    [-1, 0) and (size - 1, size], rois wider than their level, zero width
    and height), level-mapped against `roi_align_pyramid_batched` and
    every roi on every level against `_levels_pyramid_impl`: <= 1e-5 abs."""
    feats, rois = _special_case(max_samples)
    lv = jax.vmap(lambda r: jmap(r, 4))(jnp.asarray(rois))
    assert (np.asarray(lv)[:, [0, 1, 3, 4, 5]] == 0).all() and (np.asarray(lv)[:, 2] == 1).all()
    ref = j_align([jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES, lv,
                  7, 0, max_samples)
    pyr = pack_pyramid([t(f) for f in feats])
    ours = roi_align_pyramid(pyr, t(rois), t(np.array(lv)), STRIDES, 7, 0, max_samples)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert np.abs(ours[:, 6:8].numpy()).max() == 0.0
    ref = rap._levels_pyramid_impl([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                                   STRIDES, 7, 0, max_samples)
    ours = roi_align_levels(pyr, t(rois), STRIDES, 7, 0, max_samples)
    for lvl in range(4):
        np.testing.assert_allclose(ours[lvl].numpy(), np.asarray(ref[lvl]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rois_kind", ["random", "special", "inverted"])
@pytest.mark.parametrize("max_samples", [4, 2, 1])
def test_fold_model_matches_plain(rng, rois_kind, max_samples):
    """The numpy model of K2's fold (distinct corner rows and columns,
    Wy . F . Wx^T per roi) against `roi_align_plain`, level-mapped and on
    every level, within float32 rounding: 1e-5 of the largest output. On
    sub-pixel rois fewer rows than samples are distinct. "inverted" flips
    the special rois' corners (x2 < x1, y2 < y1) under a fixed grid
    (sampling_ratio = max_samples), so that sample coordinates decrease."""
    sr = 0
    if rois_kind == "random":
        feats, rois = _levels(rng, h=32, w=48), _rois(rng, r=12, h=32 * 4, w=48 * 4)
    else:
        feats, rois = _special_case(10 + max_samples)
    if rois_kind == "inverted":
        rois, sr = np.ascontiguousarray(rois[..., [2, 3, 0, 1]]), max_samples
    pyr = pack_pyramid([t(f) for f in feats])
    lv = map_roi_levels(t(rois), 4)
    passes = [lv] + [torch.full_like(lv, q) for q in range(4)]
    for lvl in passes:
        ref = roi_align_plain(pyr, t(rois), lvl, STRIDES, 7, sr, max_samples).numpy()
        ours = fold_forward(feats, rois, lvl.numpy(), STRIDES, 7, sr, max_samples)
        err = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6)
        assert err <= 1e-5, f"{err:.3g}"
    if rois_kind == "special":
        iy, wy, ix, wx, _ = fold_rois(rois[0, :1], [0], [f.shape[1:3] for f in feats],
                                      STRIDES, 7, 0, max_samples)[0]
        assert len(iy) < 7 * 2 and wy.shape == (7, len(iy)) and (wy.sum(0) > 0).all()
