"""Port parity of the FPN upsample-add (K7's plain version) and the layout
fence (K8's plain version): `htd_tpu_torch.ops.upsample` / `ops.fence`
against `htd_tpu.ops.upsample` / `htd_tpu.ops.fence` on numpy-seeded
inputs (CPU), their XLA forms and their Pallas bodies in interpret mode;
the FPN through the new op against the JAX FPN; the fence switches at
their three call sites."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import htd_tpu.ops.fence as JF
import htd_tpu.ops.upsample as JU
from htd_tpu import config as JC
from htd_tpu.models.fpn import FPN as JFPN
from htd_tpu_torch.ops import fence as PF
from htd_tpu_torch.ops import upsample as PU
from tests.torch_port import t, tiny_pair

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _pair(rng, b=2, h=6, w=10, c=16):
    return (rng.normal(0, 1, (b, h, w, c)).astype(np.float32),
            rng.normal(0, 1, (b, 2 * h, 2 * w, c)).astype(np.float32))


def _port_nhwc(a, dtype, channels_last):
    """An NHWC view of an NCHW tensor held in contiguous or channels_last
    memory, as the port's FPN hands its laterals over."""
    x = t(a).to(dtype).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last if channels_last else torch.contiguous_format)
    return x.permute(0, 2, 3, 1)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_add_matches_jax(rng, monkeypatch, dtype, layout):
    """K7's plain version is bit-equal to the JAX op's XLA form and to its
    Pallas body in interpret mode (h=12 takes the 4-row block), in float32
    and bfloat16, for laterals in either memory format; the result is a
    contiguous NHWC tensor (channels_last as NCHW)."""
    _, jdt, pdt = DTYPES[dtype]
    for h, w in ((6, 10), (12, 20)):
        low, lat = _pair(rng, h=h, w=w)
        jl, jt = jnp.asarray(low, jdt), jnp.asarray(lat, jdt)
        xla = _np(JU.upsample2x_add(jl, jt))
        monkeypatch.setattr(JU, "_INTERPRET", True)
        pallas = _np(JU._up2_add_impl(jl, jt))
        monkeypatch.setattr(JU, "_INTERPRET", False)
        cl = layout == "channels_last"
        out = PU.upsample2x_add(_port_nhwc(low, pdt, cl), _port_nhwc(lat, pdt, cl))
        assert out.dtype == pdt and out.is_contiguous()
        assert out.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(out.float().numpy(), xla)
        np.testing.assert_array_equal(out.float().numpy(), pallas)


def test_upsample_add_casts_low_to_lat_dtype(rng):
    """A float32 `low` with a bfloat16 `lat` is cast first, as the TPU
    kernel casts it: the sum is bfloat16 and bit-equal to the cast pair."""
    low, lat = _pair(rng)
    lat16 = t(lat).bfloat16()
    out = PU.upsample2x_add(t(low), lat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, PU.upsample2x_add(t(low).bfloat16(), lat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_add_vjp_matches_jax(rng, dtype):
    """d_lat = g and d_low = the 2x2 sum-pool of g, as `jax.vjp` of the JAX
    op gives them, through the autograd function: d_lat bit-equal, d_low
    within 1e-6 (float32: four terms summed in another order) or one
    bfloat16 rounding (2**-8 relative) of the JAX value."""
    _, jdt, pdt = DTYPES[dtype]
    low, lat = _pair(rng, b=1, h=4, w=6, c=8)
    g = rng.normal(0, 1, lat.shape).astype(np.float32)
    _, vjp = jax.vjp(JU.upsample2x_add, jnp.asarray(low, jdt), jnp.asarray(lat, jdt))
    j_low, j_lat = (_np(v) for v in vjp(jnp.asarray(g, jdt)))
    pl = t(low).to(pdt).requires_grad_(True)
    pt = t(lat).to(pdt).requires_grad_(True)
    out = PU.upsample2x_add(pl, pt)
    assert type(out.grad_fn).__name__ == "_Upsample2xAddBackward"
    out.backward(t(g).to(pdt))
    np.testing.assert_array_equal(pt.grad.float().numpy(), j_lat)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(pl.grad.float().numpy(), j_low, rtol=tol, atol=tol)


def test_upsample_add_other_shapes_resize(rng):
    """A pair that is not exactly 2x (9x13 over 5x7) takes `lat +
    resize_nearest(low)`, as in the JAX op: equal to it in float32; the
    gradient flows to both through plain torch ops."""
    low = rng.normal(0, 1, (1, 5, 7, 4)).astype(np.float32)
    lat = rng.normal(0, 1, (1, 9, 13, 4)).astype(np.float32)
    ref = _np(JU.upsample2x_add(jnp.asarray(low), jnp.asarray(lat)))
    pl = t(low).requires_grad_(True)
    out = PU.upsample2x_add(pl, t(lat))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-6)
    assert type(out.grad_fn).__name__ == "AddBackward0"
    out.sum().backward()
    assert pl.grad.sum().item() == pytest.approx(9 * 13 * 4)


@pytest.mark.parametrize("shape", [(24, 16), (11, 20, 16), (2, 12, 20, 16), (2, 3, 6, 10, 8)],
                         ids=["rank2", "rank3", "rank4", "rank5"])
def test_layout_fence_matches_jax(rng, monkeypatch, shape):
    """K8's plain version is the JAX fence's identity in interpret mode, bit
    for bit, and a fresh tensor with the input's strides (a channels_last
    input stays channels_last); the gradient passes through unchanged, as
    `jax.grad` of the JAX fence gives it."""
    monkeypatch.setattr(JF, "_INTERPRET", True)
    x = rng.normal(0, 1, shape).astype(np.float32)
    ref = np.asarray(JF.layout_fence(jnp.asarray(x)))
    xt = t(x)
    if len(shape) == 4:
        xt = xt.contiguous(memory_format=torch.channels_last)
    out = PF.layout_fence(xt)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.stride() == xt.stride() and out.data_ptr() != xt.data_ptr()
    j_grad = np.asarray(jax.grad(lambda a: jnp.sum(jnp.sin(JF.layout_fence(a))))(jnp.asarray(x)))
    xg = t(x).requires_grad_(True)
    torch.sin(PF.layout_fence(xg)).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(), j_grad, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def fpn_pair():
    cfg, _, variables, port = tiny_pair(seed=11)
    return variables, port.neck


@pytest.mark.parametrize("sizes", [((16, 24), (8, 12), (4, 6), (2, 3)),
                                   ((17, 25), (9, 13), (5, 7), (3, 4))],
                         ids=["exact_2x", "odd"])
def test_fpn_matches_jax(fpn_pair, sizes):
    """The port's FPN (top-down adds through `upsample2x_add`) against the
    JAX FPN on the same seeded C2-C5 in channels_last memory: P2-P6 within
    1e-4 relative (float32 convs sum in another order). The odd sizes take
    the resize branch at every level, the exact ones the op."""
    variables, neck = fpn_pair
    rng = np.random.RandomState(12)
    cs = [rng.normal(0, 1, (1, h, w, m.conv.in_channels)).astype(np.float32)
          for (h, w), m in zip(sizes, neck.lateral_convs)]
    jl = jax.jit(JFPN().apply)({"params": variables["params"]["neck"]},
                               [jnp.asarray(c) for c in cs])
    with torch.no_grad():
        pl = neck([t(c).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
                   for c in cs])
    assert len(pl) == 5
    for a, b in zip(pl, jl):
        ref = np.asarray(b)
        err = np.abs(a.permute(0, 2, 3, 1).numpy() - ref).max() / max(1.0, np.abs(ref).max())
        assert err <= 1e-4, err


def test_fpn_gradients_through_the_op(fpn_pair):
    """Every FPN parameter's gradient and C2-C5's through the autograd
    function equal those of the two-op form `lat + resize_nearest(low)`
    that the FPN computed before (float32, within 1e-6 relative: sums in
    another order), P5's lateral among them."""
    from htd_tpu_torch.models.layers import resize_nearest

    _, neck = fpn_pair
    rng = np.random.RandomState(13)
    sizes = ((16, 24), (8, 12), (4, 6), (2, 3))
    cs = [rng.normal(0, 1, (1, m.conv.in_channels, h, w)).astype(np.float32)
          for (h, w), m in zip(sizes, neck.lateral_convs)]

    def grads(top_down):
        neck.zero_grad()
        xs = [t(c).contiguous(memory_format=torch.channels_last).requires_grad_(True) for c in cs]
        lats = [m(x) for m, x in zip(neck.lateral_convs, xs)]
        for i in range(3, 0, -1):
            lats[i - 1] = top_down(lats[i], lats[i - 1])
        sum(torch.sin(f(x)).sum() for f, x in zip(neck.fpn_convs, lats)).backward()
        return [x.grad.clone() for x in xs] + [p.grad.clone() for p in neck.parameters()]

    op = grads(lambda lo, hi: PU.upsample2x_add(lo.permute(0, 2, 3, 1), hi.permute(0, 2, 3, 1))
               .permute(0, 3, 1, 2))
    ref = grads(lambda lo, hi: hi + resize_nearest(lo, hi.shape[-2:]))
    assert neck.lateral_convs[3].conv.weight.grad.abs().max() > 0
    for a, b in zip(op, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * b.abs().max().item())


def test_fence_switches_leave_detections_unchanged(monkeypatch):
    """`HTD_FPN_FENCE`, `HTD_RPN_FENCE` and `HTD_DCN_FENCE` set to 1: the
    tiny DCN detector's detections are bit-identical to the unfenced run
    and the fence runs 3 (FPN top-down sums) + 5 (RPN levels) + 3
    (deformable convs) times per forward."""
    _, _, _, port = tiny_pair(seed=8, backbone=JC.BackboneConfig(
        depth=10, stage_with_dcn=(False, True, True, True)),
        rcnn_test=JC.RCNNTestConfig(max_per_img=10, use_soft_nms=True))
    img = t(np.random.RandomState(9).normal(0, 1, (1, 64, 96, 3)).astype(np.float32))
    shapes, sf = torch.tensor([[60.0, 90.0]]), torch.tensor([[1.1, 1.2, 1.1, 1.2]])
    with torch.no_grad():
        base = port.simple_test(img, shapes, sf)
    calls = []
    plain = PF.layout_fence_plain
    monkeypatch.setattr(PF, "layout_fence_plain", lambda x: calls.append(x.shape) or plain(x))
    for switch in ("HTD_FPN_FENCE", "HTD_RPN_FENCE", "HTD_DCN_FENCE"):
        monkeypatch.setenv(switch, "1")
    with torch.no_grad():
        fenced = port.simple_test(img, shapes, sf)
    assert len(calls) == 3 + 5 + 3
    assert base.valid.any()
    for a, b in zip(base, fenced):
        assert torch.equal(a, b)
