"""Port parity: the deformable conv's gradients (`deform_conv2d_backward_plain`,
the plain version of kernels K5 and K6, and the `_DeformConv2d` autograd
function) against the JAX package's corner-folded d_x, `jax.vjp` of its
gather formulation, its Pallas backward kernels in interpret mode and
torch autograd of the plain forward (float32, CPU). Inputs come from
numpy seeds, with the anisotropic offsets of tests/test_torch_dcn.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from htd_tpu.ops.dcn import _dcn_dow_pallas, _dcn_dx_folded, _dcn_dx_pallas, _dcn_xla_impl
from htd_tpu_torch.ops.dcn import (DeformConv2d, _bilinear_gather, _sample_positions,
                                   deform_conv2d, deform_conv2d_backward_input_plain,
                                   deform_conv2d_backward_offset_weight_plain,
                                   deform_conv2d_backward_plain, deform_conv2d_plain)
from tests.test_torch_dcn import COUT, _dense, _inputs
from tests.torch_port import t

torch.set_num_threads(1)


def _cotangent(seed, off):
    rng = np.random.RandomState(seed)
    return rng.normal(0, 1, off.shape[:3] + (COUT,)).astype(np.float32)


def _close(ours, ref, rel, what):
    """ours within `rel` of max |ref|, absolute."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, what
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(ours - ref).max() / scale
    assert err <= rel, f"{what}: {err:.3g} of max |ref| (limit {rel})"


def _plain(x, off, wgt, g, stride, groups=1, deform_groups=1):
    return [a.numpy() for a in deform_conv2d_backward_plain(
        t(x), t(off), t(wgt), t(g), stride=stride, groups=groups, deform_groups=deform_groups)]


def _block_diag(dense_grad, groups):
    """The grouped (3, 3, Cin / groups, Cout) weight gradient inside the
    JAX package's block-diagonal dense one."""
    cin, cout = dense_grad.shape[2], dense_grad.shape[3]
    cg, og = cin // groups, cout // groups
    return np.concatenate([dense_grad[:, :, g * cg:(g + 1) * cg, g * og:(g + 1) * og]
                           for g in range(groups)], axis=-1)


@pytest.mark.parametrize("stride", [1, 2])
def test_dx_matches_folded(stride):
    """d_x against `_dcn_dx_folded` (the JAX package's d_x off the TPU
    kernel's path, and its stride-2 path on the TPU): within 1e-5 of max
    |d_x|, float32 sums in another order. Offsets of 3 px put corners
    outside the map."""
    x, off, wgt = _inputs(30 + stride, stride, 1, 3.0)
    g = _cotangent(40 + stride, off)
    ref = np.asarray(jax.jit(lambda a, b, c, d: _dcn_dx_folded(a, b, c, d, 3, 3, stride, 1, 1))(
        *map(jnp.asarray, (x, off, wgt, g))))
    _close(_plain(x, off, wgt, g, stride)[0], ref, 1e-5, "d_x")


@pytest.mark.parametrize("scale", [0.3, 3.0])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_matches_gather_vjp(stride, groups, scale):
    """(d_x, d_off, d_w) against `jax.vjp` of `_dcn_xla_impl(impl="gather")`
    with the block-diagonal dense weight: each within 1e-5 of its largest
    magnitude (float32, sums in another order)."""
    x, off, wgt = _inputs(50 + stride + groups, stride, groups, scale)
    g = _cotangent(60 + stride, off)
    _, vjp = jax.vjp(lambda a, b, c: _dcn_xla_impl(a, b, c, stride, 1, 1, "gather", 1, 128),
                     *map(jnp.asarray, (x, off, _dense(wgt, groups))))
    rx, roff, rw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    dx, doff, dw = _plain(x, off, wgt, g, stride, groups)
    _close(dx, rx, 1e-5, "d_x")
    _close(doff, roff, 1e-5, "d_off")
    _close(dw, _block_diag(rw, groups), 1e-5, "d_w")


@pytest.mark.parametrize("scale", [0.3, 3.0])
def test_matches_pallas_interpret(scale):
    """Against the TPU kernels `dcn_dx_pallas` and `dcn_dow_pallas` in
    interpret mode (stride 1, their only stride), with the correction cap
    at H * W so that the TPU path is exact: within 1e-5 of each gradient's
    largest magnitude, as the JAX package's own test holds them."""
    x, off, wgt = _inputs(70, 1, 1, scale)
    g = _cotangent(71, off)
    cap = x.shape[1] * x.shape[2]
    args = tuple(map(jnp.asarray, (x, off, wgt, g)))
    with jax.default_matmul_precision("highest"):
        rx = np.asarray(_dcn_dx_pallas(*args, 3, 3, 1, 1, -1, 1, cap, interpret=True))
        roff, rw = (np.asarray(a) for a in _dcn_dow_pallas(*args, 3, 3, 1, 1, -1, 1, cap,
                                                           interpret=True))
    dx, doff, dw = _plain(x, off, wgt, g, 1)
    _close(dx, rx, 1e-5, "d_x")
    _close(doff, roff, 1e-5, "d_off")
    _close(dw, rw, 1e-5, "d_w")


@pytest.mark.parametrize("stride,groups,deform_groups", [(1, 1, 1), (2, 1, 1), (1, 4, 1),
                                                         (2, 4, 2)])
def test_matches_autograd_of_plain(stride, groups, deform_groups):
    """Against torch autograd of `deform_conv2d_plain`, and through the
    `_DeformConv2d` function: within 1e-6 of each gradient's largest
    magnitude (the same float32 products, summed in another order); two
    deform groups cover the plain version's general case."""
    x, off, wgt = _inputs(80 + stride, stride, groups, 2.0, deform_groups)
    g = t(_cotangent(81, off))
    leaves = [t(a).requires_grad_() for a in (x, off, wgt)]
    ref = torch.autograd.grad(deform_conv2d_plain(*leaves, stride, 1, deform_groups, groups),
                              leaves, g)
    got = torch.autograd.grad(deform_conv2d(*leaves, stride, 1, deform_groups, groups),
                              leaves, g)
    plain = _plain(x, off, wgt, g.numpy(), stride, groups, deform_groups)
    for name, r, a, p in zip(("d_x", "d_off", "d_w"), ref, got, plain):
        _close(p, r.numpy(), 1e-6, name)
        _close(a.numpy(), r.numpy(), 1e-6, name + " through _DeformConv2d")


@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_dw_contracts_rounded_samples(stride, deform_groups):
    """bfloat16: the plain d_w (K6's tensor-core operand) equals an
    independent float64 einsum of the `_bilinear_gather` samples, each
    rounded once to bfloat16, with g: within 1e-5 of max |d_w| (float32
    sums, then one bfloat16 rounding of d_w, which this compares before).
    The same einsum of the unrounded samples is another function: it
    differs by more than 1e-4."""
    x, off, wgt = (t(a).bfloat16() for a in _inputs(90 + stride, stride, 1, 2.5, deform_groups))
    g = t(_cotangent(91 + stride, off.float().numpy())).bfloat16()
    n, h, w, cin = x.shape
    ho, wo = off.shape[1], off.shape[2]
    ys, xs = _sample_positions(n, ho, wo, 3, 3, stride, 1, off, deform_groups)
    cdg = cin // deform_groups
    flat = x.reshape(n, h * w, cin)
    samp = torch.cat([_bilinear_gather(flat[..., d * cdg:(d + 1) * cdg], h, w, ys[..., d, :],
                                       xs[..., d, :]) for d in range(deform_groups)], -1)
    g64 = g.double().numpy()

    def einsum(s):
        return np.einsum("nyxkc,nyxo->kco", s.double().numpy(), g64).reshape(wgt.shape)

    ref = einsum(samp.bfloat16())
    _, d_col = deform_conv2d_backward_input_plain(x.shape, off, wgt, g, stride, 1, deform_groups)
    _, d_w = deform_conv2d_backward_offset_weight_plain(x, off, g, d_col, wgt.shape, stride, 1,
                                                        deform_groups)
    assert d_w.dtype == torch.float32
    _close(d_w.numpy(), ref, 1e-5, "d_w")
    unrounded = einsum(samp)
    assert np.abs(unrounded - ref).max() > 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_matches_gather_vjp_bf16(stride, deform_groups):
    """bfloat16 inputs: the plain d_off and d_w (each sample rounded once to
    bfloat16 before the d_w contraction, float32 sums) against `jax.vjp` of
    `_dcn_xla_impl(impl="gather")` run in bfloat16, which also rounds the
    corner weights, products and partial sums of each sample: within 1.5e-2
    of max |ref|, the limit of the forward's bfloat16 parity test."""
    x, off, wgt = _inputs(100 + stride, stride, 1, 2.5, deform_groups)
    g = _cotangent(101 + stride, off)
    xb, ob, wb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, off, wgt, g))
    _, vjp = jax.vjp(lambda a, b, c: _dcn_xla_impl(a, b, c, stride, 1, deform_groups, "gather",
                                                   1, 128), xb, ob, wb)
    _, roff, rw = (np.asarray(a.astype(jnp.float32)) for a in vjp(gb))
    ours = deform_conv2d_backward_plain(*(t(np.asarray(a.astype(jnp.float32))).bfloat16()
                                          for a in (xb, ob, wb, gb)),
                                        stride=stride, deform_groups=deform_groups)
    assert all(a.dtype == torch.bfloat16 for a in ours)
    _close(ours[1].float().numpy(), roff, 1.5e-2, "d_off")
    _close(ours[2].float().numpy(), rw, 1.5e-2, "d_w")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_module_is_differentiable(dtype):
    """`DeformConv2d` on the CPU: its output comes from `_DeformConv2d`
    (the function whose CUDA form launches K3, K5 and K6), and every
    parameter (the DCN weight, the offset conv's weight and bias) and the
    input get a non-zero gradient. Under bfloat16 autocast the float32
    parameters meet bfloat16 activations and offsets; the module casts
    the weight and the offsets to the input's dtype, and the parameters'
    gradients come back float32."""
    rng = np.random.RandomState(9)
    m = DeformConv2d(8, 16, stride=2)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(t(rng.normal(0, 0.3, tuple(p.shape)).astype(np.float32)))
    x = t(rng.normal(0, 1, (2, 8, 11, 13)).astype(np.float32)).requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
        out = m(x.to(dtype))
    assert type(out.grad_fn).__name__ == "PermuteBackward0"
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "_DeformConv2dBackward"
    assert out.dtype == dtype
    out.float().square().sum().backward()
    for name, p in [("x", x)] + list(m.named_parameters()):
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
