"""Port parity of test-time augmentation: box flip and mapping,
`preprocess(flip=True, boxes=...)`, `pad_gt`, the TTA merges and
`aug_inference_detector` (htd_tpu_torch vs htd_tpu, numpy-seeded inputs,
float32, CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from htd_tpu import apis as japis
from htd_tpu import config as JC
from htd_tpu.data import pipeline as jpipe
from htd_tpu.models import tta as jtta
from htd_tpu.ops import boxes as jboxes
from htd_tpu_torch import apis as papis
from htd_tpu_torch.data import pipeline as ppipe
from htd_tpu_torch.models import tta as ptta
from htd_tpu_torch.ops import boxes as pboxes
from tests.test_e2e_parity import _assert_rows_match_or_tie
from tests.torch_port import port_config, t, tiny_pair

torch.set_num_threads(1)


def _boxes(rng, n, w=90.0, h=60.0):
    xy = rng.uniform(0, [w * 0.8, h * 0.8], (n, 2))
    wh = rng.uniform(2, [w * 0.6, h * 0.6], (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1).astype(np.float32)


@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
def test_bbox_flip_and_mapping_match(rng, direction):
    """`bbox_flip`, `bbox_mapping` and `bbox_mapping_back` are bit-equal to
    the JAX functions, and mapping back undoes mapping within one float32
    rounding of the division."""
    b = _boxes(rng, 16)
    shape, sf = (60.0, 90.0), np.array([1.25, 1.5, 1.25, 1.5], np.float32)
    np.testing.assert_array_equal(pboxes.bbox_flip(t(b), shape, direction).numpy(),
                                  np.asarray(jboxes.bbox_flip(jnp.asarray(b), shape, direction)))
    for flip in (False, True):
        fwd = pboxes.bbox_mapping(t(b), shape, t(sf), flip, direction)
        np.testing.assert_array_equal(fwd.numpy(), np.asarray(jboxes.bbox_mapping(
            jnp.asarray(b), shape, sf, flip, direction)))
        back = pboxes.bbox_mapping_back(fwd, shape, t(sf), flip, direction)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jboxes.bbox_mapping_back(
            jnp.asarray(fwd.numpy()), shape, sf, flip, direction)))
        np.testing.assert_allclose(back.numpy(), b, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        pboxes.bbox_flip(t(b), shape, "diagonal")


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("hw", [(480, 640), (800, 600)])
def test_preprocess_flip_boxes_match(rng, hw, flip):
    """Resize -> flip -> BGR to RGB -> normalize -> pad, with gt boxes
    scaled, clipped to the resized shape and mirrored in the resized width:
    shapes, scale factors, boxes, labels, the flag and the pixels agree
    exactly (the port's resize is cv2's INTER_LINEAR bit for bit)."""
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    gts = np.concatenate([_boxes(rng, 5, hw[1], hw[0]), [[-4, 3, hw[1] + 9, 40]]]).astype(
        np.float32)
    labels = np.arange(6, dtype=np.int32)
    scale = (1333, 800)
    bucket = jpipe.bucket_shape(scale, hw[1] >= hw[0])
    j = jpipe.preprocess(img, scale=scale, bucket=bucket, flip=flip, boxes=gts, labels=labels)
    p = ppipe.preprocess(img, scale=scale, bucket=bucket, flip=flip, boxes=gts, labels=labels)
    np.testing.assert_array_equal(p.img_shape.numpy(), j.img_shape)
    np.testing.assert_array_equal(p.scale_factor.numpy(), j.scale_factor)
    np.testing.assert_array_equal(p.boxes.numpy(), j.boxes)
    np.testing.assert_array_equal(p.labels.numpy(), j.labels)
    assert p.flipped == j.flipped == flip
    np.testing.assert_array_equal(p.image.numpy(), j.image)
    new_h, new_w = (int(v) for v in j.img_shape)
    assert not p.image[new_h:].any() and not p.image[:, new_w:].any()


def test_preprocess_flip_bit_equal_under_one_resize(rng):
    img = rng.randint(0, 256, (333, 500, 3)).astype(np.uint8)
    gts = _boxes(rng, 4, 500, 333)
    j = jpipe.preprocess(img, scale=(1333, 800), flip=True, boxes=gts)
    p = ppipe.preprocess(img, scale=(1333, 800), flip=True, boxes=gts)
    np.testing.assert_array_equal(p.image.numpy(), j.image)
    np.testing.assert_array_equal(p.boxes.numpy(), j.boxes)


@pytest.mark.parametrize("n", [0, 3, 12])
def test_pad_gt_matches(rng, n):
    """`pad_gt` pads (or cuts) to `max_gt` rows exactly as the JAX one."""
    b, lab = _boxes(rng, n), rng.randint(0, 80, n).astype(np.int32)
    for got, want in zip(ppipe.pad_gt(t(b), t(lab), 8), jpipe.pad_gt(b, lab, 8)):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def _aug_lists(rng, augs=3, p=40, c=5):
    boxes = [_boxes(rng, p) for _ in range(augs)]
    scores = [rng.uniform(0, 1, p).astype(np.float32) for _ in range(augs)]
    valid = [rng.uniform(0, 1, p) > 0.2 for _ in range(augs)]
    probs = [rng.dirichlet(np.ones(c + 1), p).astype(np.float32) for _ in range(augs)]
    return boxes, scores, valid, probs


def test_tta_map_and_merge_proposals_match(rng):
    """`map_back` / `map_into` bit-equal to the JAX functions; proposals of
    three augs merged by NMS (0.7, 50 slots) give the same boxes, scores
    and validity, bit for bit."""
    boxes, scores, valid, _ = _aug_lists(rng)
    shape, sf = t(np.array([60.0, 90.0], np.float32)), np.array([1.5, 1.5, 1.5, 1.5], np.float32)
    for fl in (False, True):
        for pf, jf in ((ptta.map_back, jtta.map_back), (ptta.map_into, jtta.map_into)):
            np.testing.assert_array_equal(pf(t(boxes[0]), shape, t(sf), fl).numpy(), np.asarray(
                jf(jnp.asarray(boxes[0]), jnp.asarray(shape.numpy()), sf, fl)))
    cfg = JC.ProposalConfig(nms_thr=0.7, max_num=50)
    j = jtta.merge_aug_proposals([jnp.asarray(b) for b in boxes], [jnp.asarray(s) for s in scores],
                                 [jnp.asarray(v) for v in valid], cfg)
    p = ptta.merge_aug_proposals([t(b) for b in boxes], [t(s) for s in scores],
                                 [t(v) for v in valid], port_config(cfg))
    assert p[2].sum() > 0
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_tta_merge_bboxes_and_final_nms_match(rng, soft):
    """The mean of three augs' boxes and scores within 1e-6 (float32 means
    summed in another order), then `final_nms` (hard, or linear soft-NMS
    as the DCN presets test) on the same merged inputs: the same
    detections, boxes and scores bit for bit."""
    boxes, _, valid, probs = _aug_lists(rng)
    jb, js = jtta.merge_aug_bboxes([jnp.asarray(b) for b in boxes],
                                   [jnp.asarray(s) for s in probs])
    pb, ps = ptta.merge_aug_bboxes([t(b) for b in boxes], [t(s) for s in probs])
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
    cfg = JC.RCNNTestConfig(max_per_img=20, use_soft_nms=soft)
    mb, ms = np.array(jb), np.array(js)
    j = jtta.final_nms(jnp.asarray(mb), jnp.asarray(ms), jnp.asarray(valid[0]), cfg)
    p = ptta.final_nms(t(mb), t(ms), t(valid[0]), port_config(cfg))
    assert p[3].sum() > 0
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def pair():
    cfg, jm, variables, port = tiny_pair(seed=21)
    img = np.random.RandomState(22).randint(0, 256, (64, 96, 3)).astype(np.uint8)
    return cfg, jm, variables, port, img


SCALES = ((96, 64), (80, 56))   # one 64x96 bucket: one JAX compile per method


def test_aug_inference_matches_jax(pair):
    """Two scales with flip (4 augs) on the tiny detector: the same number
    of detections as the JAX package's `aug_inference_detector`, boxes
    within 1e-2 px and scores within 1e-3 after matching rows (score ties
    may reorder), finite and inside the image."""
    cfg, jm, variables, port, img = pair
    jb, js, jl = japis.aug_inference_detector(jm, variables, img, scales=SCALES, flip=True)
    pb, ps, pl = papis.aug_inference_detector(port, img, scales=SCALES, flip=True)
    assert len(ps) == len(js) > 0 and len(ps) <= cfg.rcnn_test.max_per_img
    assert np.isfinite(pb).all() and pb.min() >= 0
    assert pb[:, 2].max() <= 96 + 1e-3 and pb[:, 3].max() <= 64 + 1e-3
    _assert_rows_match_or_tie(np.asarray(jb), np.asarray(js), pb, ps, np.asarray(jl), pl,
                              box_tol=1e-2)


def test_aug_inference_identity_is_inference(pair):
    """One aug at the test scale without flip gives `inference_detector`'s
    detections: boxes within 1e-2 px and scores within 1e-3 (the rois pass
    through one more map back and forth, and the merge's NMS)."""
    _, _, _, port, img = pair
    ib, is_, il = papis.inference_detector(port, img, scale=SCALES[0])
    ab, as_, al = papis.aug_inference_detector(port, img, scales=SCALES[:1], flip=False)
    assert len(as_) == len(is_) > 0
    _assert_rows_match_or_tie(ib, is_, ab, as_, il, al, box_tol=1e-2)


def test_rpn_proposals_matches_jax(pair):
    """`rpn_proposals` (the proposal pass of every aug): the same valid
    count, boxes within 1e-2 px and scores within 1e-3 of the JAX method,
    in score order."""
    cfg, jm, variables, port, _ = pair
    img = np.random.RandomState(23).normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    shapes = np.array([[60.0, 90.0]], np.float32)
    jb, js, jv = jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.rpn_proposals))(
        variables, jnp.asarray(img), jnp.asarray(shapes))
    with torch.no_grad():
        pb, ps, pv = port.rpn_proposals(t(img), t(shapes))
    jv, pv = np.asarray(jv[0]), pv[0].numpy()
    assert jv.sum() == pv.sum() > 0
    np.testing.assert_allclose(ps[0].numpy()[pv], np.asarray(js[0])[jv], atol=1e-3)
    np.testing.assert_allclose(pb[0].numpy()[pv], np.asarray(jb[0])[jv], atol=1e-2)
