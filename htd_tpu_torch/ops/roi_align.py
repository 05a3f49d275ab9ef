"""Level-mapped RoIAlign read from the packed pyramid (kernel K2) and its
feature gradient (kernel K4).

Function: mmcv `RoIAlign(aligned=True)` with the adaptive grid
(`sampling_ratio=0`: ceil(bin extent) samples per bin axis) clamped at
`max_samples`, bilinear samples clamped to the level's [0, size-1],
samples outside [-1, size] contributing zero, and each bin averaged over
max(grid_h * grid_w, 1). Each roi is aligned on its mapped FPN level; the
BA extractor aligns every roi on every level. This is the JAX package's
`roi_align_pyramid_batched` and `_levels_pyramid_impl`
(`htd_tpu/ops/roi_align.py`, `htd_tpu/ops/roi_align_pallas.py`), read
from the pyramid of `ops/pyramid.py`.

The wrappers `roi_align_pyramid` and `roi_align_levels` launch the CUDA
kernel (`csrc/roi_align.cu`) on CUDA tensors and run the plain version
(`roi_align_plain`, a gather and a weighted sum, the JAX package's
`_roi_align_core`) on CPU tensors. Layouts are the JAX package's: rois
(B, R, 4), outputs (B, R, out, out, C).

Both wrappers are differentiable with respect to the pyramid buffer. On
CUDA tensors the backward launches K4 (`csrc/roi_align_bwd.cu`, the
TPU's `roi_align_pallas_v4_bwd` and the BA pass's
`levels_pyramid_grad_feats`); on CPU tensors autograd differentiates the
plain version. `roi_align_backward_plain` is K4's plain version, an
`index_add_` of the forward's corner weights.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from htd_tpu_torch.ops.pyramid import Pyramid, PyramidGeometry, pack_pyramid

# the plain version gathers (rois x out^2 x (2S)^2) rows; it processes rois
# in chunks whose gathered float32 rows stay under this many bytes
_PLAIN_CHUNK_BYTES = 256 * 2**20


def _sample_geometry(rois, scale, fh, fw, out_size, sampling_ratio, max_samples):
    """Per-roi sample positions and bilinear corner tables, per axis.

    Returns (x_low, x_high, lx, hx, mx, x_in, y_low, y_high, ly, hy, my,
    y_in, grid_w, grid_h); tables are (R, out, S). The same operations in
    the same order as the JAX package, so discrete decisions (grid counts,
    floors, border tests) agree exactly in float32.
    """
    r = rois.shape[0]
    o = out_size
    s = int(sampling_ratio) if sampling_ratio > 0 else int(max_samples)
    f32 = torch.float32
    dev = rois.device
    rois = rois.to(f32)
    start_w = rois[:, 0] * scale - 0.5
    start_h = rois[:, 1] * scale - 0.5
    # divide by a tensor: on CUDA, PyTorch turns division by a Python scalar
    # into multiplication by its reciprocal, which is not correctly rounded
    out_t = torch.full((r,), float(o), dtype=f32, device=dev)
    bin_w = (rois[:, 2] - rois[:, 0]) * scale / out_t
    bin_h = (rois[:, 3] - rois[:, 1]) * scale / out_t
    if sampling_ratio > 0:
        grid_w = torch.full((r,), sampling_ratio, dtype=torch.int32, device=dev)
        grid_h = grid_w.clone()
    else:
        grid_w = torch.ceil(bin_w).clamp(0, s).to(torch.int32)
        grid_h = torch.ceil(bin_h).clamp(0, s).to(torch.int32)

    p = torch.arange(o, dtype=f32, device=dev)
    i = torch.arange(s, dtype=f32, device=dev)
    gw = grid_w.clamp(min=1).to(f32)[:, None, None]
    gh = grid_h.clamp(min=1).to(f32)[:, None, None]
    x = start_w[:, None, None] + (p[None, :, None] + (i[None, None, :] + 0.5) / gw) * bin_w[:, None, None]
    y = start_h[:, None, None] + (p[None, :, None] + (i[None, None, :] + 0.5) / gh) * bin_h[:, None, None]
    mx = i[None, None, :] < grid_w.to(f32)[:, None, None]
    my = i[None, None, :] < grid_h.to(f32)[:, None, None]

    def axis_interp(coord, size):
        inside = (coord >= -1.0) & (coord <= size)
        cc = coord.clamp(min=0.0)
        low = torch.minimum(torch.floor(cc), size - 1.0)
        high = torch.minimum(low + 1.0, size - 1.0)
        frac = torch.where(cc >= size - 1.0, torch.zeros_like(cc), cc - low)
        return low.to(torch.int64), high.to(torch.int64), frac, inside

    x_low, x_high, lx, x_in = axis_interp(x, fw.to(f32)[:, None, None])
    y_low, y_high, ly, y_in = axis_interp(y, fh.to(f32)[:, None, None])
    return (x_low, x_high, lx, 1.0 - lx, mx, x_in,
            y_low, y_high, ly, 1.0 - ly, my, y_in, grid_w, grid_h)


def _corner_table(rois, scale, fh, fw, row_offset, row_stride, out_size,
                  sampling_ratio, max_samples):
    """For (R, 4) rois: every sample corner's bilinear weight (R, out,
    out, K) with K = (2S)^2 (zero for masked samples), its flat feature row
    (R, out, out, K), and each roi's sample count max(grid_h * grid_w, 1)."""
    r = rois.shape[0]
    o = out_size
    f32 = torch.float32
    (x_low, x_high, lx, hx, mx, x_in,
     y_low, y_high, ly, hy, my, y_in,
     grid_w, grid_h) = _sample_geometry(rois, scale, fh, fw, out_size,
                                        sampling_ratio, max_samples)
    k = 2 * x_low.shape[-1]
    wy = (torch.stack([hy, ly], -1) * (my & y_in)[..., None].to(f32)).reshape(r, o, k)
    wx = (torch.stack([hx, lx], -1) * (mx & x_in)[..., None].to(f32)).reshape(r, o, k)
    iy = torch.stack([y_low, y_high], -1).reshape(r, o, k)
    ix = torch.stack([x_low, x_high], -1).reshape(r, o, k)
    wgt = (wy[:, :, None, :, None] * wx[:, None, :, None, :]).reshape(r, o, o, k * k)
    row = iy * row_stride[:, None, None] + row_offset[:, None, None]
    idx = (row[:, :, None, :, None] + ix[:, None, :, None, :]).reshape(r, o, o, k * k)
    count = (grid_h * grid_w).clamp(min=1).to(f32)
    return wgt, idx, count


def _gather_core(flat, rois, scale, fh, fw, row_offset, row_stride, out_size,
                 sampling_ratio, max_samples):
    """Plain RoIAlign of (R, 4) rois over flat feature rows (N, C)."""
    wgt, idx, count = _corner_table(rois, scale, fh, fw, row_offset, row_stride,
                                    out_size, sampling_ratio, max_samples)
    v = flat[idx.reshape(-1)].reshape(wgt.shape + (flat.shape[-1],)).to(torch.float32)
    out = torch.einsum("rhwk,rhwkc->rhwc", wgt, v)
    return (out / count[:, None, None, None]).to(flat.dtype)


def _scatter_core(d_flat, g, rois, scale, fh, fw, row_offset, row_stride, out_size,
                  sampling_ratio, max_samples) -> None:
    """Transpose of `_gather_core`: adds each sample corner's weight times
    g / count into the float32 rows `d_flat` (N, C), in place. The
    JAX package's `roi_align_pyramid_flat_grad_feats` without its fold."""
    wgt, idx, count = _corner_table(rois, scale, fh, fw, row_offset, row_stride,
                                    out_size, sampling_ratio, max_samples)
    gg = g.to(torch.float32) / count[:, None, None, None]
    vals = wgt[..., None] * gg[:, :, :, None, :]
    d_flat.index_add_(0, idx.reshape(-1), vals.reshape(-1, d_flat.shape[-1]))


def _level_tables(geom: PyramidGeometry, strides: Sequence[int], device):
    scale = torch.tensor([1.0 / s for s in strides], dtype=torch.float32, device=device)
    hs = torch.tensor(geom.heights, dtype=torch.float32, device=device)
    ws = torch.tensor(geom.widths, dtype=torch.float32, device=device)
    offs = torch.tensor(geom.row_offsets, dtype=torch.int64, device=device)
    return scale, hs, ws, offs


def _roi_chunks(geom: PyramidGeometry, rois: torch.Tensor, lvls: torch.Tensor,
                strides: Sequence[int], out_size: int, sampling_ratio: int,
                max_samples: int):
    """Per-roi arguments of `_gather_core` / `_scatter_core` for (B, R)
    rois on levels (B, R), in chunks whose gathered float32 rows stay
    under `_PLAIN_CHUNK_BYTES`: yields (slice, args)."""
    b, r = rois.shape[0], rois.shape[1]
    dev = rois.device
    scale, hs, ws, offs = _level_tables(geom, strides, dev)
    rois_f = rois.reshape(-1, 4)
    lv = lvls.reshape(-1).to(torch.int64)
    img = torch.arange(b, device=dev).repeat_interleave(r)
    row_offset = (img * geom.img_rows + offs[lv]) * geom.w_pad
    row_stride = torch.full_like(row_offset, geom.w_pad)
    s = sampling_ratio if sampling_ratio > 0 else max_samples
    per_roi = out_size * out_size * (2 * s) ** 2 * geom.channels * 4
    chunk = max(1, _PLAIN_CHUNK_BYTES // per_roi)
    for a in range(0, b * r, chunk):
        sl = slice(a, a + chunk)
        lv_c = lv[sl]
        yield sl, (rois_f[sl], scale[lv_c], hs[lv_c], ws[lv_c], row_offset[sl],
                   row_stride[sl], out_size, sampling_ratio, max_samples)


def roi_align_plain(pyr: Pyramid, rois: torch.Tensor, lvls: torch.Tensor,
                    strides: Sequence[int], out_size: int = 7,
                    sampling_ratio: int = 0, max_samples: int = 4) -> torch.Tensor:
    """Plain version of K2: (B, R, 4) rois on levels (B, R) ->
    (B, R, out, out, C), read from the pyramid buffer. Differentiable
    with respect to the buffer (its autograd is K4's function)."""
    buf, geom = pyr
    b, r = rois.shape[0], rois.shape[1]
    flat = buf.reshape(-1, geom.channels)
    outs = [_gather_core(flat, *args) for _, args in
            _roi_chunks(geom, rois, lvls, strides, out_size, sampling_ratio, max_samples)]
    out = torch.cat(outs) if outs else flat.new_zeros((0, out_size, out_size, geom.channels))
    return out.reshape(b, r, out_size, out_size, geom.channels)


def roi_align_backward_plain(geom: PyramidGeometry, rois: torch.Tensor,
                             lvls: Optional[torch.Tensor], g: torch.Tensor,
                             strides: Sequence[int], out_size: int = 7,
                             sampling_ratio: int = 0, max_samples: int = 4) -> torch.Tensor:
    """Plain version of K4, the feature gradient of K2: the cotangent g of
    `roi_align_pyramid` (B, R, out, out, C), or with `lvls=None` of
    `roi_align_levels` (L, B, R, out, out, C), -> the float32 pyramid
    gradient (rows_pad, w_pad, C). An `index_add_` of the forward's
    corner weights times g / count."""
    b, r = rois.shape[0], rois.shape[1]
    d = torch.zeros((geom.rows_pad * geom.w_pad, geom.channels), dtype=torch.float32,
                    device=rois.device)
    if lvls is None:
        passes = [(torch.full((b, r), q, dtype=torch.int64, device=rois.device), g[q])
                  for q in range(len(geom.heights))]
    else:
        passes = [(lvls, g)]
    for lv, gl in passes:
        g_flat = gl.reshape(b * r, out_size, out_size, geom.channels)
        for sl, args in _roi_chunks(geom, rois, lv, strides, out_size, sampling_ratio,
                                    max_samples):
            _scatter_core(d, g_flat[sl], *args)
    return d.reshape(geom.rows_pad, geom.w_pad, geom.channels)


def _check_rois(pyr: Pyramid, rois: torch.Tensor, lvls: Optional[torch.Tensor]):
    if rois.dim() != 3 or rois.shape[-1] != 4 or rois.shape[0] != pyr.geom.batch:
        raise ValueError(f"rois must be (B={pyr.geom.batch}, R, 4), got {tuple(rois.shape)}")
    if rois.device != pyr.buf.device:
        raise ValueError("rois and pyramid are on different devices")
    if lvls is not None and tuple(lvls.shape) != tuple(rois.shape[:2]):
        raise ValueError(f"levels must be (B, R), got {tuple(lvls.shape)}")


def roi_align_pyramid(pyr: Pyramid, rois: torch.Tensor, lvls: torch.Tensor,
                      strides: Sequence[int], out_size: int = 7,
                      sampling_ratio: int = 0, max_samples: int = 4) -> torch.Tensor:
    """Level-mapped RoIAlign: (B, R, 4) rois, (B, R) levels ->
    (B, R, out, out, C), in the pyramid's dtype."""
    _check_rois(pyr, rois, lvls)
    if len(strides) != len(pyr.geom.heights):
        raise ValueError("one stride per pyramid level")
    dev = pyr.buf.device.type
    if dev == "cpu":
        return roi_align_plain(pyr, rois, lvls, strides, out_size,
                               sampling_ratio, max_samples)
    if dev != "cuda":
        raise ValueError(f"roi_align_pyramid runs on cuda or cpu tensors, not {dev}")
    return _RoIAlign.apply(pyr.buf, pyr.geom, rois, lvls, tuple(strides), out_size,
                           sampling_ratio, max_samples)


def roi_align_levels(pyr: Pyramid, rois: torch.Tensor, strides: Sequence[int],
                     out_size: int = 7, sampling_ratio: int = 0,
                     max_samples: int = 1) -> torch.Tensor:
    """Every roi on every level (the BA extractor's pass):
    (B, R, 4) -> (L, B, R, out, out, C). One kernel launch on CUDA."""
    _check_rois(pyr, rois, None)
    num_levels = len(pyr.geom.heights)
    if len(strides) != num_levels:
        raise ValueError("one stride per pyramid level")
    dev = pyr.buf.device.type
    if dev == "cpu":
        return torch.stack([
            roi_align_plain(pyr, rois, torch.full(rois.shape[:2], lvl, dtype=torch.int32),
                            strides, out_size, sampling_ratio, max_samples)
            for lvl in range(num_levels)
        ])
    if dev != "cuda":
        raise ValueError(f"roi_align_levels runs on cuda or cpu tensors, not {dev}")
    return _RoIAlign.apply(pyr.buf, pyr.geom, rois, None, tuple(strides), out_size,
                           sampling_ratio, max_samples)


class _RoIAlign(torch.autograd.Function):
    """K2 forward, K4 backward, on CUDA tensors. The gradient flows into the
    pyramid buffer only (None for rois and levels, as the JAX package's
    custom VJPs): K4 accumulates it in float32, then it is cast to the
    buffer's dtype (`.astype(f.dtype)` in the JAX package)."""

    @staticmethod
    def forward(ctx, buf, geom, rois, lvls, strides, out_size, sampling_ratio, max_samples):
        from htd_tpu_torch.ops.roi_align_cuda import launch_roi_align

        ctx.save_for_backward(rois, lvls)
        ctx.args = (geom, strides, out_size, sampling_ratio, max_samples)
        return launch_roi_align(Pyramid(buf, geom), rois, lvls, strides, out_size,
                                sampling_ratio, max_samples)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from htd_tpu_torch.ops.roi_align_cuda import launch_roi_align_bwd

        rois, lvls = ctx.saved_tensors
        geom, strides, out_size, sampling_ratio, max_samples = ctx.args
        d = launch_roi_align_bwd(geom, rois, lvls, g.contiguous(), strides, out_size,
                                 sampling_ratio, max_samples)
        return (d.to(g.dtype),) + (None,) * 7


def roi_align_pyramid_batched(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                              strides: Sequence[int], target_lvls: torch.Tensor,
                              out_size: int = 7, sampling_ratio: int = 0,
                              max_samples: int = 4) -> torch.Tensor:
    """The JAX package's signature: per-level (B, H, W, C) maps, (B, R, 4)
    rois and (B, R) levels -> (B, R, out, out, C). Packs the pyramid (K1)
    and aligns (K2)."""
    return roi_align_pyramid(pack_pyramid(feats), rois, target_lvls, strides,
                             out_size, sampling_ratio, max_samples)
