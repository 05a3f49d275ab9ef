"""Port parity: config, box, anchor and NMS ops, preprocessing and the
package's import and device contracts (htd_tpu_torch vs htd_tpu, CPU)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from htd_tpu import config as JC
from htd_tpu.data import pipeline as jpipe
from htd_tpu.ops import anchors as janchors
from htd_tpu.ops import boxes as jboxes
from htd_tpu.ops import nms as jnms
from htd_tpu_torch import config as PC
from htd_tpu_torch.data import pipeline as ppipe
from htd_tpu_torch.ops import anchors as panchors
from htd_tpu_torch.ops import boxes as pboxes
from htd_tpu_torch.ops import nms as pnms
from tests.torch_port import PORT_ONLY, on_keys, t

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _boxes(rng, n, span=200.0, size=(2.0, 60.0)):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("preset", ["htd_r50_1x", "htd_r101_2x", "htd_r101_dcn_2x",
                                    "htd_x101_dcn_2x"])
def test_config_presets_match(preset):
    """The port's config copy cannot drift from the JAX package's: on the
    JAX package's keys the two presets are equal, and the fields the JAX
    package lacks are the port's DetectoRS fields, at their defaults."""
    port = dataclasses.asdict(getattr(PC, preset)())
    jax_side = dataclasses.asdict(getattr(JC, preset)())
    cut, extra = on_keys(port, jax_side)
    assert cut == jax_side
    assert sorted(extra) == sorted(PORT_ONLY)
    for key, default in PORT_ONLY.items():
        group, field = key.split(".")
        assert port[group][field] == default, key


def test_box_ops_match(rng):
    """bbox2delta / delta2bbox (wh clip, max_shape) / overlaps / levels:
    float32 results within 1e-5 relative, levels identical."""
    a = _boxes(rng, 64)
    b = _boxes(rng, 64)
    means, stds = (0.1, -0.1, 0.0, 0.05), (0.1, 0.1, 0.2, 0.2)
    np.testing.assert_allclose(
        pboxes.bbox2delta(t(a), t(b), means, stds).numpy(),
        np.asarray(jboxes.bbox2delta(jnp.asarray(a), jnp.asarray(b), means, stds)),
        rtol=1e-5, atol=1e-5)
    d = rng.normal(0, 2.0, (64, 4)).astype(np.float32)  # exercises wh_ratio_clip
    np.testing.assert_allclose(
        pboxes.delta2bbox(t(a), t(d), means, stds, max_shape=(150.0, 190.0)).numpy(),
        np.asarray(jboxes.delta2bbox(jnp.asarray(a), jnp.asarray(d), means, stds,
                                     max_shape=(150.0, 190.0))),
        rtol=1e-5, atol=1e-4)
    for mode in ("iou", "iof"):
        np.testing.assert_allclose(
            pboxes.bbox_overlaps(t(a), t(b), mode).numpy(),
            np.asarray(jboxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode)),
            rtol=1e-5, atol=1e-6)
    big = _boxes(rng, 256, span=800, size=(1.0, 500.0))
    np.testing.assert_array_equal(
        pboxes.map_roi_levels(t(big), 4).numpy(),
        np.asarray(jboxes.map_roi_levels(jnp.asarray(big), 4)))


def test_anchors_match():
    """Grid anchors and pad-region valid flags are identical."""
    pg, jg = panchors.AnchorGenerator(), janchors.AnchorGenerator()
    for lvl, size in enumerate([(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]):
        np.testing.assert_array_equal(pg.grid_anchors_level(lvl, size).numpy(),
                                      np.asarray(jg.grid_anchors_level(lvl, size)))
        shape = np.array([50.0, 70.0], np.float32)
        np.testing.assert_array_equal(
            pg.valid_flags_level(lvl, size, t(shape)).numpy(),
            np.asarray(jg.valid_flags_level(lvl, size, jnp.asarray(shape))))


def _tied_scores(rng, n):
    """Scores with many exact ties and some absent (-inf) entries."""
    s = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)
    s[rng.uniform(0, 1, n) < 0.1] = -np.inf
    return s


@pytest.mark.parametrize("n", [40, 700])  # JAX argmax loop / blocked form
def test_nms_matches_with_ties(rng, n):
    """Greedy NMS: identical kept indices, scores and valid masks."""
    boxes = _boxes(rng, n, span=150)
    scores = _tied_scores(rng, n)
    ids = rng.randint(0, 3, n).astype(np.int32)
    for fn_p, fn_j, extra in ((pnms.nms, jnms.nms, ()),
                              (pnms.batched_nms, jnms.batched_nms, (ids,))):
        pk, ps, pv = fn_p(t(boxes), t(scores), *[t(e) for e in extra], 0.5, 100)
        jk, js, jv = jax.jit(lambda *a: fn_j(*a, 0.5, 100))(
            jnp.asarray(boxes), jnp.asarray(scores), *[jnp.asarray(e) for e in extra])
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_multiclass_nms_matches(rng):
    """Class-offset NMS over (roi, class) candidates with tied scores and
    the candidate cap: identical padded outputs."""
    n, c = 60, 5
    boxes = _boxes(rng, n, span=100)
    scores = np.round(rng.uniform(0, 0.5, (n, c + 1)), 2).astype(np.float32)
    for cap in (2048, 50):
        p = pnms.multiclass_nms(t(boxes), t(scores), 0.05, 0.5, 30, candidate_cap=cap)
        j = jax.jit(lambda b, s: jnms.multiclass_nms(b, s, 0.05, 0.5, 30,
                                                    candidate_cap=cap))(
            jnp.asarray(boxes), jnp.asarray(scores))
        for pa, ja in zip(p, j):
            np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


@pytest.mark.parametrize("n", [40, 300])
def test_soft_nms_matches_with_ties(rng, n):
    """Linear soft-NMS over overlapping boxes with tied and absent scores:
    identical indices and validity, scores within 1e-6."""
    boxes = _boxes(rng, n, span=80)
    scores = _tied_scores(rng, n)
    pk, ps, pv = pnms.soft_nms(t(boxes), t(scores), 0.3, 0.05, 60)
    jk, js, jv = jax.jit(lambda b, s: jnms.soft_nms(b, s, iou_threshold=0.3, min_score=0.05,
                                                   method="linear", max_out=60))(
        jnp.asarray(boxes), jnp.asarray(scores))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pv.sum() > 0
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("duplicated", [False, True], ids=["distinct", "duplicated"])
def test_multiclass_soft_nms_matches(rng, monkeypatch, duplicated):
    """multiclass_nms(use_soft_nms=True) with tied scores and the candidate
    cap, and with every box twice (a threshold float32 cannot hold): the
    same labels, validity and boxes, scores within 1e-6. On CPU tensors it
    runs `soft_nms_plain`: the kernel's launcher is never called."""
    from htd_tpu_torch.ops import nms_cuda

    def launch_soft_nms(*args):
        raise AssertionError("CPU tensors reached the soft-NMS kernel's launcher")

    monkeypatch.setattr(nms_cuda, "launch_soft_nms", launch_soft_nms)
    n, c, iou, max_out = (40, 4, 0.3, 25) if duplicated else (60, 5, 0.5, 30)
    boxes = _boxes(rng, n, span=90 if duplicated else 100)
    if duplicated:
        boxes[1::2] = boxes[0::2]
    scores = np.round(rng.uniform(0, 0.4 if duplicated else 0.5, (n, c + 1)), 2)
    scores = scores.astype(np.float32)
    for cap in (2048, 50):
        p = pnms.multiclass_nms(t(boxes), t(scores), 0.05, iou, max_out, candidate_cap=cap,
                                use_soft_nms=True, soft_min_score=0.05)
        j = jax.jit(lambda b, s: jnms.multiclass_nms(b, s, 0.05, iou, max_out,
                                                    candidate_cap=cap, use_soft_nms=True,
                                                    soft_min_score=0.05))(
            jnp.asarray(boxes), jnp.asarray(scores))
        assert p[3].sum() > 0
        for k in (0, 2, 3):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))
        np.testing.assert_allclose(p[1].numpy(), np.asarray(j[1]), rtol=0, atol=1e-6)
    if duplicated:
        # a dead duplicate of an emitted box decays to -inf * 0 = NaN, which
        # the next round emits as an invalid slot: compare the scores' bits
        plain = pnms.soft_nms_plain(t(boxes), t(scores[:, 0]), iou, 0.05, max_out)
        assert plain[1].isnan().any()
        for a, b in zip(pnms.soft_nms(t(boxes), t(scores[:, 0]), iou, 0.05, max_out), plain):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                               b.view(torch.int32) if b.is_floating_point() else b)


_F32 = torch.float32


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA tensors"), ("float64", "float32"), ("bfloat16_scores", "float32"),
    ("boxes_shape", r"boxes \(N, 4\)"), ("scores_shape", r"boxes \(N, 4\)"),
    ("no_boxes", "1 to 2"), ("max_out", "max_out"), ("strided", "contiguous")])
def test_soft_nms_launcher_rejects_before_loading(monkeypatch, case, match):
    """`launch_soft_nms` raises ValueError on what its kernel does not take
    (CPU tensors, another dtype, another shape, no boxes, max_out < 1,
    strided tensors) before it loads the kernel library."""
    from htd_tpu_torch.ops import _build
    from htd_tpu_torch.ops.nms_cuda import launch_soft_nms

    def load():
        raise AssertionError("the launcher loaded the library")

    monkeypatch.setattr(_build, "load", load)
    boxes, scores, max_out = torch.zeros(6, 4, dtype=_F32), torch.zeros(6, dtype=_F32), 5
    if case == "float64":
        boxes = boxes.double()
    elif case == "bfloat16_scores":
        scores = scores.bfloat16()
    elif case == "boxes_shape":
        boxes = torch.zeros(6, 5, dtype=_F32)
    elif case == "scores_shape":
        scores = torch.zeros(6, 1, dtype=_F32)
    elif case == "no_boxes":
        boxes, scores = boxes[:0], scores[:0]
    elif case == "max_out":
        max_out = 0
    elif case == "strided":
        boxes = torch.zeros(4, 6, dtype=_F32).t()
    with pytest.raises(ValueError, match=match):
        launch_soft_nms(boxes, scores, 0.5, 0.05, max_out)


@pytest.mark.parametrize("case, match", [
    ("cpu", "CUDA tensors"), ("boxes_shape", r"boxes \(N, 4\)"),
    ("scores_shape", r"boxes \(N, 4\)"), ("too_many", "at most 131072"),
    ("max_out", "max_out")])
def test_hard_nms_launcher_rejects_before_loading(monkeypatch, case, match):
    """`launch_nms` raises ValueError on what its kernels do not take (CPU
    tensors, another shape, more boxes than the scan's shared words hold,
    max_out < 1) before it sorts anything or loads the kernel library."""
    from htd_tpu_torch.ops import _build
    from htd_tpu_torch.ops.nms_cuda import launch_nms

    def load():
        raise AssertionError("the launcher loaded the library")

    monkeypatch.setattr(_build, "load", load)
    boxes, scores, max_out = torch.zeros(6, 4), torch.zeros(6), 5
    if case == "boxes_shape":
        boxes = torch.zeros(6, 5)
    elif case == "scores_shape":
        scores = torch.zeros(6, 1)
    elif case == "too_many":
        boxes, scores = torch.zeros(131073, 4), torch.zeros(131073)
    elif case == "max_out":
        max_out = 0
    with pytest.raises(ValueError, match=match):
        launch_nms(boxes, scores, 0.7, max_out)


def _tile_scan(boxes, scores, thr, max_out):
    """The hard-NMS kernels (csrc/nms.cu) step for step, in Python: the mask
    launch's 64-bit words of the score-sorted boxes' suppressions (bit k of
    row i's word w: box 64 w + k comes after i and IoU > thr, from
    `_sorted_iou`), then the scan. The removed words start from the absent
    boxes and those past N. At tile c the helpers OR the kept rows of tile
    c - 1 into words c + 1 and on, while warp 0 takes the tile's keep set as
    the fixpoint of its own suppressions from kept = open = ~(removed[c] |
    carry), drops its highest boxes past `max_out`, and ORs the kept rows'
    words c + 1 into the carry for the next tile; it stops at `max_out`."""
    order = np.argsort(-scores, kind="stable")
    sscores = scores[order]
    n = len(order)
    words = -(-n // 64)
    sup = np.zeros((n, 64 * words), bool)
    sup[:, :n] = np.triu((pnms._sorted_iou(torch.from_numpy(boxes[order])) > thr).numpy(), 1)
    mask = np.packbits(sup, axis=1, bitorder="little").view("<u8")
    absent = np.ones(64 * words, bool)
    absent[:n] = ~(sscores > -np.inf)
    removed = [int(w) for w in np.packbits(absent, bitorder="little").view("<u8")]
    full = (1 << 64) - 1
    keep, prev, carry = [], [], 0
    for c in range(words):
        for r in prev:
            for w in range(c + 1, words):
                removed[w] |= int(mask[r, w])
        tile_open = ~(removed[c] | carry) & full
        kept = tile_open
        while True:
            hit = 0
            for k in range(64):
                if kept >> k & 1:
                    hit |= int(mask[64 * c + k, c])
            step = tile_open & ~hit
            if step == kept:
                break
            kept = step
        while len(keep) + bin(kept).count("1") > max_out:
            kept &= ~(1 << (kept.bit_length() - 1))
        prev = [64 * c + k for k in range(64) if kept >> k & 1]
        keep += prev
        carry = 0
        for r in prev:
            carry |= int(mask[r, c + 1]) if c + 1 < words else 0
        if len(keep) >= max_out:
            break
    idx = np.zeros(max_out, np.int64)
    score = np.full(max_out, -np.inf, np.float32)
    idx[:len(keep)] = order[keep]
    score[:len(keep)] = sscores[keep]
    return idx, score, score > -np.inf


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 700])
@pytest.mark.parametrize("max_out", [5, 1000])
def test_tile_scan_is_the_fixpoint(rng, monkeypatch, n, max_out):
    """On CPU tensors `nms` runs `nms_plain` (the launcher is never called),
    and the kernels' algorithm, modelled step for step by `_tile_scan` (each
    tile's own fixpoint, the carry into the next tile, the helpers' ORs a
    tile behind, the cut at `max_out`), gives its outputs at sizes that are
    and are not whole tiles, with ties, absent entries and chains of
    suppressions, stopping early or not."""
    from htd_tpu_torch.ops import nms_cuda

    def launch_nms(*args):
        raise AssertionError("CPU tensors reached the hard-NMS kernels' launcher")

    monkeypatch.setattr(nms_cuda, "launch_nms", launch_nms)
    boxes = _boxes(rng, n, span=120)
    scores = _tied_scores(rng, n)
    got = pnms.nms(t(boxes), t(scores), 0.5, max_out)
    for a, b in zip(got, pnms.nms_plain(t(boxes), t(scores), 0.5, max_out)):
        assert torch.equal(a, b)
    for a, b in zip(got, _tile_scan(boxes, scores, 0.5, max_out)):
        np.testing.assert_array_equal(a.numpy(), b)
    kept = int(got[2].sum())
    assert kept <= max_out and (kept > 0 or n == 1)
    assert kept == max_out or n < 300 or max_out == 1000   # the scan stopped early


def test_coder_consts_are_made_once_and_kept(monkeypatch):
    """The box coder's constants are made at their first use, in the one
    `htd.sync.box_coder` span, then kept and handed out again: one tensor
    per (values, dtype, device), made outside inference mode even when
    first used inside it, so that autograd may save it (a decode whose
    deltas need a gradient)."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(pboxes, "_CODER_CONSTS", {})
    stds, deltas = (0.1, 0.1, 0.2, 0.2), torch.randn(7, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            first = pboxes._coder_consts(stds, deltas)
        again = pboxes._coder_consts(list(stds), deltas)
        other = pboxes._coder_consts(stds, deltas.double())
    spans = [e for e in prof.events() if e.name == "htd.sync.box_coder"]
    assert len(spans) == 2 and len(pboxes._CODER_CONSTS) == 2
    assert again is first and other is not first and not first.is_inference()
    assert torch.equal(first, torch.tensor(stds))
    rois = t(_boxes(np.random.RandomState(0), 7))
    d = deltas.clone().requires_grad_(True)
    pboxes.delta2bbox(rois, d, (0.0, 0.0, 0.0, 0.0), stds).sum().backward()
    assert d.grad is not None and torch.isfinite(d.grad).all()


def test_roi_extractor_impl_names(rng):
    """Every RoIAlign implementation name of the JAX package gives the same
    output (one RoIAlign in the port); any other name raises, as in
    `htd_tpu/models/roi_extract.py`."""
    from htd_tpu_torch.models.roi_extract import single_roi_extract_batched
    from htd_tpu_torch.ops.pyramid import pack_pyramid

    feats = [t(rng.normal(0, 1, (1, 32 >> i, 48 >> i, 8)).astype(np.float32))
             for i in range(4)]
    pyr = pack_pyramid(feats)
    rois = t(_boxes(rng, 12, span=120, size=(4.0, 90.0))[None])
    outs = [single_roi_extract_batched(pyr, rois, PC.RoIExtractorConfig(impl=name))
            for name in ("auto", "pallas", "pallas_v3", "pallas_v4", "gather")]
    for o in outs[1:]:
        np.testing.assert_array_equal(o.numpy(), outs[0].numpy())
    with pytest.raises(ValueError, match="unknown roi extractor impl"):
        single_roi_extract_batched(pyr, rois, PC.RoIExtractorConfig(impl="window"))


@pytest.mark.parametrize("hw,new_hw", [
    ((480, 640), (800, 1067)), ((720, 1280), (750, 1333)), ((1000, 1500), (800, 1200)),
    ((427, 640), (800, 1199)), ((960, 1280), (480, 640)), ((37, 53), (61, 89)),
    ((89, 61), (40, 27)), ((1, 9), (3, 4)), ((5, 7), (5, 7))],
    ids=["up", "up_wide", "down", "up_odd", "down_2x", "small_up", "small_down", "one_row",
         "same"])
def test_resize_bilinear_is_cv2(hw, new_hw):
    """`resize_bilinear` is `cv2.resize(INTER_LINEAR)` bit for bit on seeded
    uint8 images: upscales, downscales, an exact 2x downscale (which cv2
    runs as INTER_AREA, the same function there), odd small sizes and the
    identity."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(hw[0] * 7 + hw[1]).randint(0, 256, hw + (3,)).astype(np.uint8)
    ref = cv2.resize(img, new_hw[::-1], interpolation=cv2.INTER_LINEAR)
    got = ppipe.resize_bilinear(torch.from_numpy(img), *new_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == new_hw + (3,)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("hw", [(480, 640), (333, 500), (800, 600)])
def test_preprocess_matches(rng, hw):
    """Resize + normalize + pad: shapes, scale factors, the bucket and the
    pixels agree exactly (the port's resize is cv2's INTER_LINEAR bit for
    bit)."""
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    scale = (1333, 800)
    bucket = jpipe.bucket_shape(scale, hw[1] >= hw[0])
    assert ppipe.bucket_shape(scale, hw[1] >= hw[0]) == bucket
    j = jpipe.preprocess(img, scale=scale, bucket=bucket)
    p = ppipe.preprocess(img, scale=scale, bucket=bucket)
    np.testing.assert_array_equal(p.img_shape.numpy(), j.img_shape)
    np.testing.assert_array_equal(p.scale_factor.numpy(), j.scale_factor)
    assert p.image.shape == j.image.shape
    np.testing.assert_array_equal(p.image.numpy(), j.image)


def test_port_imports_no_jax():
    """Importing every module of the port (the training, checkpoint and PNG
    modules included) and every tool in tools_torch/ loads no jax, flax,
    optax or htd_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import htd_tpu_torch, tools_torch\n"
        "for pkg in (htd_tpu_torch, tools_torch):\n"
        "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "for m in ('htd_tpu_torch.train.train_step', 'htd_tpu_torch.train.checkpoint',\n"
        "          'htd_tpu_torch.data.png', 'tools_torch.train', 'tools_torch.test',\n"
        "          'tools_torch.eval_metric', 'tools_torch.coco_error_analysis',\n"
        "          'tools_torch.publish_model', 'tools_torch.print_config',\n"
        "          'tools_torch.analyze_logs', 'tools_torch.train_smoke'):\n"
        "    assert m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'htd_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'optax.', 'htd_tpu.'))]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "", f"port imported {out.stdout.strip()}"


def test_entry_points_need_a_device(monkeypatch):
    """With no CUDA and no device given the entry points raise; they run on
    the CPU only when asked."""
    from htd_tpu_torch.apis import init_detector, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_detector(PC.htd_r50_1x())
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
