"""Launcher for the CUDA kernel K3 (deformable conv forward,
`csrc/deform_conv.cu`).

It checks what the kernel takes (device, dtype, shape, contiguity,
alignment) and raises on anything else, allocates the output, launches on
PyTorch's current stream, raises when the launch reports an error, and
adds one to `launch_counts["deform_conv"]`. There is no fallback: a CUDA
tensor goes through the kernel or the call raises. The public wrapper
that picks between the kernel and its plain version by device is
`ops.dcn.deform_conv2d`.
"""

from __future__ import annotations

import torch

from htd_tpu_torch.ops.roi_align_cuda import _DTYPE_CODE, _check, _stream, launch_counts


def launch_deform_conv(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                       stride: int, dilation: int, deform_groups: int,
                       groups: int) -> torch.Tensor:
    """K3: x (N, H, W, Cin) and offsets (N, Ho, Wo, 18), contiguous; weight
    (3, 3, Cin / groups, Cout) whose memory is in (Cout, 3, 3, Cin / groups)
    order (`DeformConv2d.hwio_weight()`); CUDA tensors of one dtype ->
    (N, Ho, Wo, Cout). Shapes were checked by `ops.dcn.deform_conv2d`."""
    from htd_tpu_torch.ops._build import load

    if x.device.type != "cuda":
        raise ValueError("launch_deform_conv takes CUDA tensors")
    if x.dtype not in _DTYPE_CODE or offsets.dtype != x.dtype or weight.dtype != x.dtype:
        raise ValueError(f"K3 takes float32 or bfloat16 x, offsets and weight of one dtype, "
                         f"not {x.dtype}, {offsets.dtype}, {weight.dtype}")
    kh, kw, cg, cout = weight.shape
    if (kh, kw) != (3, 3) or deform_groups != 1:
        raise ValueError("K3 takes 3x3 kernels with one deform group")
    vec = 16 // x.element_size()
    if cg % vec or (cout // groups) % 4:
        raise ValueError(f"K3 needs Cin/groups a multiple of {vec} and Cout/groups of 4, "
                         f"got {cg} and {cout // groups}")
    for name, t in (("x", x), ("offsets", offsets), ("weight", weight.permute(3, 0, 1, 2))):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous (x, offsets NHWC; weight in "
                             f"(Cout, 3, 3, Cin/groups) memory order) and 16-byte aligned")
    n, h, w, cin = x.shape
    ho, wo = offsets.shape[1], offsets.shape[2]
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    lib, _ = load()
    err = lib.htd_deform_conv_fwd(
        x.data_ptr(), offsets.data_ptr(), weight.data_ptr(), out.data_ptr(), n, h, w, cin,
        ho, wo, cout, groups, stride, dilation, dilation, _DTYPE_CODE[x.dtype], _stream())
    _check(err, "deform_conv")
    launch_counts["deform_conv"] += 1
    return out
