"""Port parity: the deformable conv forward (`htd_tpu_torch.ops.dcn`, the
plain version of kernel K3) against the JAX package's gather formulation
and its Pallas kernel in interpret mode (float32; bfloat16 against the
gather run in bfloat16; CPU). Inputs are made
with numpy from a seed, with anisotropic random offsets so that a swapped
(y, x) layout cannot pass."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from htd_tpu.ops import dcn_pallas
from htd_tpu.ops.dcn import _dcn_xla_impl
from htd_tpu_torch.ops.dcn import DeformConv2d, deform_conv2d
from tests.torch_port import t

torch.set_num_threads(1)
N, H, W, CIN, COUT = 2, 11, 13, 8, 16


def _inputs(seed, stride, groups, scale, deform_groups=1):
    """x (N, H, W, Cin); offsets with dy of std `scale` and dx of std
    `scale` / 2 plus a shift of +0.4 px; grouped HWIO weight."""
    rng = np.random.RandomState(seed)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.normal(0, 1, (N, H, W, CIN)).astype(np.float32)
    off = rng.normal(0, 1, (N, ho, wo, deform_groups * 9, 2))
    off = off * [scale, scale / 2] + [0.0, 0.4]
    off = off.reshape(N, ho, wo, deform_groups * 18).astype(np.float32)
    wgt = rng.normal(0, 0.5, (3, 3, CIN // groups, COUT)).astype(np.float32)
    return x, off, wgt


def _dense(wgt, groups):
    """Grouped HWIO weight -> the block-diagonal dense weight the JAX
    package's `deform_conv2d` takes."""
    cg, cout = wgt.shape[2], wgt.shape[3]
    og = cout // groups
    dense = np.zeros((3, 3, cg * groups, cout), np.float32)
    for g in range(groups):
        dense[:, :, g * cg:(g + 1) * cg, g * og:(g + 1) * og] = wgt[:, :, :, g * og:(g + 1) * og]
    return dense


def _jax_gather(x, off, wgt, stride, deform_groups=1):
    return np.asarray(jax.jit(
        lambda a, b, c: _dcn_xla_impl(a, b, c, stride, 1, deform_groups, "gather", 1, 128))(
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt)))


@pytest.mark.parametrize("scale", [0.3, 2.5, 30.0])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_matches_gather(stride, groups, scale):
    """Against `_dcn_xla_impl(impl="gather")`: float32 within 1e-5
    absolute at unit-scale inputs (the two contract in different orders).
    Offsets of 2.5 and 30 px put samples outside the image."""
    x, off, wgt = _inputs(10 + stride, stride, groups, scale)
    ref = _jax_gather(x, off, _dense(wgt, groups), stride)
    out = deform_conv2d(t(x), t(off), t(wgt), stride=stride, groups=groups).numpy()
    assert out.shape == ref.shape
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_plain_matches_gather_deform_groups():
    """Two deform groups (the plain version's general case; every HTD
    config uses one), stride 2, samples outside the image."""
    x, off, wgt = _inputs(3, 2, 1, 2.5, deform_groups=2)
    ref = _jax_gather(x, off, wgt, 2, deform_groups=2)
    out = deform_conv2d(t(x), t(off), t(wgt), stride=2, deform_groups=2).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_bf16_matches_gather_bf16(stride, deform_groups):
    """bfloat16 inputs: the plain version (each sample blended in float32
    and rounded once to bfloat16, float32 sums, as K3's tensor cores
    compute it) against `_dcn_xla_impl(impl="gather")` run in bfloat16,
    which rounds the corner weights, each corner product and each partial
    sum of a sample to bfloat16: within 1.5e-2 of max |ref| (about four
    bfloat16 ulps). Both against the float32 gather of the same bfloat16
    values within 1e-2 of its max."""
    x, off, wgt = _inputs(30 + stride, stride, 1, 2.5, deform_groups=deform_groups)
    xb, ob, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, off, wgt))
    ref = np.asarray(jax.jit(lambda a, b, c: _dcn_xla_impl(
        a, b, c, stride, 1, deform_groups, "gather", 1, 128))(xb, ob, wb).astype(jnp.float32))
    exact = _jax_gather(*(np.asarray(a.astype(jnp.float32)) for a in (xb, ob, wb)), stride,
                        deform_groups)
    out = deform_conv2d(*(t(a).bfloat16() for a in (x, off, wgt)), stride=stride,
                        deform_groups=deform_groups)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    scale = np.abs(exact).max()
    assert np.abs(out - ref).max() <= 1.5e-2 * np.abs(ref).max()
    assert np.abs(out - exact).max() <= 1e-2 * scale
    assert np.abs(ref - exact).max() <= 1e-2 * scale


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_matches_pallas_interpret(monkeypatch, stride):
    """Against the TPU kernel `dcn_sample_conv_pallas` in interpret mode
    through `dcn_conv_windowed`, with the correction cap above the number
    of flagged pixels so that the TPU path is exact: within 1e-4, as the
    JAX package's own test holds it."""
    monkeypatch.setattr(dcn_pallas, "_INTERPRET", True)
    x, off, wgt = _inputs(20 + stride, stride, 1, 2.5)
    n_px = off.shape[1] * off.shape[2]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(dcn_pallas.dcn_conv_windowed(
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt), pad=1, dilation=1, m=1,
            cap=n_px + 1, stride=stride))
    out = deform_conv2d(t(x), t(off), t(wgt), stride=stride).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 4])
def test_module_with_zero_offsets_is_a_conv(groups):
    """`DeformConv2d` (mmcv names and layouts, NCHW in and out) with a zero
    `conv_offset` computes `F.conv2d` of its weight."""
    rng = np.random.RandomState(4)
    m = DeformConv2d(CIN, COUT, stride=2, groups=groups)
    with torch.no_grad():
        m.weight.copy_(t(rng.normal(0, 0.5, tuple(m.weight.shape)).astype(np.float32)))
        m.conv_offset.weight.zero_()
        m.conv_offset.bias.zero_()
        x = t(rng.normal(0, 1, (N, CIN, H, W)).astype(np.float32))
        ref = F.conv2d(x, m.weight, stride=2, padding=1, groups=groups)
        np.testing.assert_allclose(m(x).numpy(), ref.numpy(), rtol=0, atol=1e-5)
        assert set(m.state_dict()) == {"weight", "conv_offset.weight", "conv_offset.bias"}


def test_rejects_mismatched_shapes():
    x, off, wgt = _inputs(5, 1, 1, 1.0)
    with pytest.raises(ValueError):
        deform_conv2d(t(x), t(off[:, :-1]), t(wgt))
    with pytest.raises(ValueError):
        deform_conv2d(t(x), t(off), t(wgt), groups=3)
