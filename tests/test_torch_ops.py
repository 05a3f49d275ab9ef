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
from tests.torch_port import t

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def _boxes(rng, n, span=200.0, size=(2.0, 60.0)):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("preset", ["htd_r50_1x", "htd_r101_2x", "htd_r101_dcn_2x",
                                    "htd_x101_dcn_2x"])
def test_config_presets_match(preset):
    """The port's config copy cannot drift from the JAX package's."""
    assert (dataclasses.asdict(getattr(PC, preset)())
            == dataclasses.asdict(getattr(JC, preset)()))


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


def test_multiclass_soft_nms_matches(rng):
    """multiclass_nms(use_soft_nms=True) with tied scores and the candidate
    cap: the same labels, validity and boxes, scores within 1e-6."""
    n, c = 60, 5
    boxes = _boxes(rng, n, span=100)
    scores = np.round(rng.uniform(0, 0.5, (n, c + 1)), 2).astype(np.float32)
    for cap in (2048, 50):
        p = pnms.multiclass_nms(t(boxes), t(scores), 0.05, 0.5, 30, candidate_cap=cap,
                                use_soft_nms=True, soft_min_score=0.05)
        j = jax.jit(lambda b, s: jnms.multiclass_nms(b, s, 0.05, 0.5, 30, candidate_cap=cap,
                                                    use_soft_nms=True,
                                                    soft_min_score=0.05))(
            jnp.asarray(boxes), jnp.asarray(scores))
        for k in (0, 2, 3):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]))
        np.testing.assert_allclose(p[1].numpy(), np.asarray(j[1]), rtol=0, atol=1e-6)


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
