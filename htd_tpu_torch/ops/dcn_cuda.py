"""Launchers for the CUDA kernels K3 (deformable conv forward,
`csrc/deform_conv.cu`), K5 (its input gradient and column gradient,
`csrc/deform_conv_bwd_input.cu`) and K6 (its offset and weight gradients,
`csrc/deform_conv_bwd_offset_weight.cu`).

Each checks what its kernel takes (device, dtype, shape, contiguity,
alignment) and raises on anything else, allocates the outputs, launches on
PyTorch's current stream, raises when the launch reports an error, and
adds one to its entry in `launch_counts`. There is no fallback: a CUDA
tensor goes through the kernel or the call raises. The public wrapper
that picks between the kernels and their plain versions by device is
`ops.dcn.deform_conv2d`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from htd_tpu_torch.ops.roi_align_cuda import _DTYPE_CODE, _check, _stream, launch_counts


def _check_inputs(name: str, weight_shape, groups: int, deform_groups: int,
                  channel_vec: Tuple[int, int], **tensors: torch.Tensor) -> None:
    """What K3, K5 and K6 share: CUDA tensors of one dtype, 3x3 with one
    deform group, Cin/groups and Cout/groups multiples of `channel_vec`
    (in units of the 16-byte vector when 0), contiguous and 16-byte
    aligned (a weight given as `weight` in (Cout, 3, 3, Cin/groups) memory
    order)."""
    first = next(iter(tensors.values()))
    if any(t.device.type != "cuda" or t.device != first.device for t in tensors.values()):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if first.dtype not in _DTYPE_CODE or any(t.dtype != first.dtype for t in tensors.values()):
        raise ValueError(f"{name} takes float32 or bfloat16 tensors of one dtype, not "
                         + ", ".join(f"{k} {t.dtype}" for k, t in tensors.items()))
    kh, kw, cg, cout = weight_shape
    if (kh, kw) != (3, 3) or deform_groups != 1:
        raise ValueError(f"{name} takes 3x3 kernels with one deform group")
    vec = 16 // first.element_size()
    need_c, need_o = (m or vec for m in channel_vec)
    if cg % need_c or (cout // groups) % need_o:
        raise ValueError(f"{name} needs Cin/groups a multiple of {need_c} and Cout/groups of "
                         f"{need_o}, got {cg} and {cout // groups}")
    for key, t in tensors.items():
        t = t.permute(3, 0, 1, 2) if key == "weight" else t
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{key} must be contiguous (NHWC; a weight in (Cout, 3, 3, "
                             f"Cin/groups) memory order) and 16-byte aligned")


def launch_deform_conv(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                       stride: int, dilation: int, deform_groups: int,
                       groups: int) -> torch.Tensor:
    """K3: x (N, H, W, Cin) and offsets (N, Ho, Wo, 18), contiguous; weight
    (3, 3, Cin / groups, Cout) whose memory is in (Cout, 3, 3, Cin / groups)
    order (`DeformConv2d.hwio_weight()`); CUDA tensors of one dtype ->
    (N, Ho, Wo, Cout). Shapes were checked by `ops.dcn.deform_conv2d`."""
    from htd_tpu_torch.ops._build import load

    _check_inputs("K3", weight.shape, groups, deform_groups, (0, 4), x=x, offsets=offsets,
                  weight=weight)
    n, h, w, cin = x.shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    cout = weight.shape[-1]
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    lib, _ = load()
    err = lib.htd_deform_conv_fwd(
        x.data_ptr(), offsets.data_ptr(), weight.data_ptr(), out.data_ptr(), n, h, w, cin,
        ho, wo, cout, groups, stride, dilation, dilation, _DTYPE_CODE[x.dtype], _stream())
    _check(err, "deform_conv")
    launch_counts["deform_conv"] += 1
    return out


def launch_deform_conv_bwd_input(x_shape, offsets: torch.Tensor, weight: torch.Tensor,
                                 g: torch.Tensor, stride: int, dilation: int,
                                 deform_groups: int, groups: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: the cotangent g (N, Ho, Wo, Cout) of K3's output, with K3's
    offsets and weight (one dtype, K3's layouts), for an input of shape
    `x_shape` (N, H, W, Cin) -> (d_x in g's dtype, summed in float32;
    d_col (N, Ho, Wo, 9, Cin) float32, for K6)."""
    from htd_tpu_torch.ops._build import load

    _check_inputs("K5", weight.shape, groups, deform_groups, (4, 0), offsets=offsets,
                  weight=weight, g=g)
    n, h, w, cin = x_shape
    ho, wo, cout = g.shape[1], g.shape[2], g.shape[3]
    d_x = torch.zeros((n, h, w, cin), dtype=torch.float32, device=g.device)
    d_col = torch.empty((n, ho, wo, 9, cin), dtype=torch.float32, device=g.device)
    lib, _ = load()
    err = lib.htd_deform_conv_bwd_input(
        g.data_ptr(), offsets.data_ptr(), weight.data_ptr(), d_x.data_ptr(), d_col.data_ptr(),
        n, h, w, cin, ho, wo, cout, groups, stride, dilation, dilation,
        _DTYPE_CODE[g.dtype], _stream())
    _check(err, "deform_conv_bwd_input")
    launch_counts["deform_conv_bwd_input"] += 1
    return d_x.to(g.dtype), d_col


def launch_deform_conv_bwd_offset_weight(x: torch.Tensor, offsets: torch.Tensor,
                                         g: torch.Tensor, d_col: torch.Tensor,
                                         weight_shape, stride: int, dilation: int,
                                         deform_groups: int, groups: int
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: K3's x and offsets, the cotangent g and K5's d_col -> (d_off
    (N, Ho, Wo, 18) in the offsets' dtype; d_w float32 of `weight_shape`
    (3, 3, Cin / groups, Cout), a view of (Cout, 3, 3, Cin / groups)
    memory as K3 reads the weight)."""
    from htd_tpu_torch.ops._build import load

    _check_inputs("K6", weight_shape, groups, deform_groups, (0, 0), x=x, offsets=offsets, g=g)
    n, h, w, cin = x.shape
    ho, wo, cout = g.shape[1], g.shape[2], g.shape[3]
    if tuple(d_col.shape) != (n, ho, wo, 9, cin) or d_col.dtype != torch.float32 \
            or not d_col.is_contiguous() or d_col.device != x.device:
        raise ValueError(f"d_col must be K5's contiguous float32 (N, Ho, Wo, 9, Cin), got "
                         f"{tuple(d_col.shape)} {d_col.dtype}")
    if n * h * w >= 2**31:
        raise ValueError("K6 indexes input pixels with 32-bit integers")
    kh, kw, cg, _ = weight_shape
    d_off = torch.empty_like(offsets)
    d_w = torch.zeros((cout, kh, kw, cg), dtype=torch.float32, device=x.device)
    lib, _ = load()
    err = lib.htd_deform_conv_bwd_offset_weight(
        x.data_ptr(), offsets.data_ptr(), g.data_ptr(), d_col.data_ptr(), d_off.data_ptr(),
        d_w.data_ptr(), n, h, w, cin, ho, wo, cout, groups, stride, dilation, dilation,
        _DTYPE_CODE[x.dtype], _stream())
    _check(err, "deform_conv_bwd_offset_weight")
    launch_counts["deform_conv_bwd_offset_weight"] += 1
    return d_off, d_w.permute(1, 2, 3, 0)
