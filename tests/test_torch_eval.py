"""Port parity of the dataset and evaluation path: `CocoDataset`,
`grouped_batches`, the batch makers, `evaluate_coco_map`,
`precision_curves`, `eval_recalls`, `eval_map`, `evaluate_dataset`,
`evaluate_proposals` and `calibrate_dcn`'s statistics (htd_tpu_torch vs
htd_tpu on a synthetic mini-COCO written to disk, CPU)."""

import json

import numpy as np
import pytest
import torch

from htd_tpu import apis as japis
from htd_tpu import config as JC
from htd_tpu.data import coco as jcoco
from htd_tpu.data import coco_eval as jeval
from htd_tpu.data import mean_ap as jmap
from htd_tpu_torch import apis as papis
from htd_tpu_torch.data import coco as pcoco
from htd_tpu_torch.data import coco_eval as peval
from htd_tpu_torch.data import mean_ap as pmap
from tests.test_e2e_parity import _assert_rows_match_or_tie
from tests.torch_port import t, tiny_pair

torch.set_num_threads(1)
SCALE = (96, 64)


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """Seven images (60x90 landscape, 90x60 portrait) with two to three
    annotations each over categories 1 and 3, one crowd box, one ignored,
    one of zero area, and a box over most of the image (which the clipped
    proposals of the largest anchors cover); the last image without
    annotations."""
    import cv2

    root = tmp_path_factory.mktemp("minicoco")
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(7):
        h, w = (60, 90) if i % 2 == 0 else (90, 60)
        name = f"img{i}.png"
        cv2.imwrite(str(root / name), rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        for k in range(0 if i == 6 else 2 + i % 2):
            x, y = rng.uniform(-4, w / 2), rng.uniform(-4, h / 2)
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=int(rng.choice([1, 3])),
                             bbox=[float(x), float(y), float(bw), float(bh)],
                             area=0.0 if (i, k) == (3, 1) else float(bw * bh),
                             iscrowd=int((i, k) == (1, 2)), ignore=(i, k) == (4, 0)))
        if i < 6:
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                             bbox=[2.0, 1.0, w - 3.0, h - 4.0], area=float((w - 3) * (h - 4)),
                             iscrowd=0))
    ann_file = root / "ann.json"
    ann_file.write_text(json.dumps(dict(
        images=images, annotations=anns, categories=[dict(id=1, name="a"), dict(id=3, name="b")])))
    return str(ann_file), str(root)


@pytest.mark.parametrize("test_mode", [True, False])
def test_dataset_matches(mini_coco, test_mode):
    """Records (ids, sizes, boxes, labels, crowd boxes), the label map,
    `groundtruth` and `load_image` are the JAX dataset's, with and without
    the train filtering."""
    ann, root = mini_coco
    jd, pd = jcoco.CocoDataset(ann, root, test_mode), pcoco.CocoDataset(ann, root, test_mode)
    assert len(pd) == len(jd) == (7 if test_mode else 6)
    assert pd.cat2label == jd.cat2label == {1: 0, 3: 1} and pd.classes == jd.classes
    for a, b in zip(pd.records, jd.records):
        assert (a.img_id, a.file_name, a.height, a.width, a.landscape) == \
            (b.img_id, b.file_name, b.height, b.width, b.landscape)
        for f in ("boxes", "labels", "crowd_boxes"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    jg, pg = jd.groundtruth(), pd.groundtruth()
    assert set(pg) == set(jg)
    assert any(c.any() for _, _, c in pg.values())
    for k in jg:
        for a, b in zip(pg[k], jg[k]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pd.load_image(pd.records[0]), jd.load_image(jd.records[0]))


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False), (True, True)])
def test_grouped_batches_match(mini_coco, shuffle, drop_last):
    """The same orientation-homogeneous batches, in the same order."""
    ann, root = mini_coco
    jd, pd = jcoco.CocoDataset(ann, root, True), pcoco.CocoDataset(ann, root, True)
    j = [[r.img_id for r in b] for b in jcoco.grouped_batches(jd, 2, shuffle, 3, drop_last)]
    p = [[r.img_id for r in b] for b in pcoco.grouped_batches(pd, 2, shuffle, 3, drop_last)]
    assert p == j and len(p) >= 3
    assert all(len({pd.records[0].landscape for _ in b}) == 1 for b in p)


def test_batch_makers_match(mini_coco):
    """`make_test_batch` (a short batch padded to 4 with id -1) and
    `make_train_batch` (seeded flips, gts padded to 8) give the JAX
    arrays bit for bit; `sample_mstrain_scale` draws the same scales."""
    ann, root = mini_coco
    jd, pd = jcoco.CocoDataset(ann, root, False), pcoco.CocoDataset(ann, root, False)
    recs_j = next(jcoco.grouped_batches(jd, 3, False))
    recs_p = next(pcoco.grouped_batches(pd, 3, False))
    j = jcoco.make_test_batch(jd, recs_j, scale=SCALE, batch_size=4)
    p = pcoco.make_test_batch(pd, recs_p, scale=SCALE, batch_size=4)
    assert list(p[3]) == list(j[3]) and p[3][-1] == -1
    for a, b in zip(p[:3], j[:3]):
        np.testing.assert_array_equal(a.numpy(), b)
    j = jcoco.make_train_batch(jd, recs_j, scale=SCALE, max_gt=8, rng=np.random.RandomState(5))
    p = pcoco.make_train_batch(pd, recs_p, scale=SCALE, max_gt=8, rng=np.random.RandomState(5))
    assert p.gt_valid.any()
    for key, got in p._asdict().items():
        assert got.numpy().dtype == j[key].dtype, key
        np.testing.assert_array_equal(got.numpy(), j[key], err_msg=key)
    rj, rp = np.random.RandomState(7), np.random.RandomState(7)
    rng_scales = ((1600, 400), (1600, 1400))
    assert [pcoco.sample_mstrain_scale(rp, rng_scales) for _ in range(6)] == \
        [jcoco.sample_mstrain_scale(rj, rng_scales) for _ in range(6)]


def _dets_and_gts(rng, n_img=6, n_cls=3):
    """Seeded detections and gts: each gt detected with jitter by some
    detections, plus random false positives; crowd gts in two images."""
    dets, gts = {}, {}
    for i in range(n_img):
        g = rng.uniform(0, 300, (5, 2))
        gb = np.concatenate([g, g + rng.uniform(5, 200, (5, 2))], 1)
        gl = rng.randint(0, n_cls, 5)
        gc = np.zeros(5, bool)
        gc[4] = i % 3 == 0
        hit = gb[:4] + rng.normal(0, 6, (4, 4))
        fp = rng.uniform(0, 400, (6, 2))
        db = np.concatenate([hit, np.concatenate([fp, fp + rng.uniform(5, 100, (6, 2))], 1)])
        dets[i + 1] = (db.astype(np.float32), rng.uniform(0.05, 1, 10).astype(np.float32),
                       np.concatenate([gl[:4], rng.randint(0, n_cls, 6)]))
        gts[i + 1] = (gb.astype(np.float32), gl, gc)
    return dets, gts


def test_coco_map_and_curves_match(rng):
    """`evaluate_coco_map` and `precision_curves` on the same detections:
    every metric within 1e-12 of the JAX evaluator's (which takes its
    native matcher where it builds); the gt given as detections scores
    mAP 1.0."""
    dets, gts = _dets_and_gts(rng)
    p, j = peval.evaluate_coco_map(dets, gts, 3), jeval.evaluate_coco_map(dets, gts, 3)
    assert set(p) == set(j) and 0.0 < p["mAP"] < 1.0
    for k in j:
        assert abs(p[k] - j[k]) <= 1e-12 or (np.isnan(p[k]) and np.isnan(j[k])), k
    np.testing.assert_allclose(peval.precision_curves(dets, gts, [0, 1, 2]),
                               jeval.precision_curves(dets, gts, [0, 1, 2]), rtol=0, atol=1e-12)
    perfect = {k: (b[~c], np.ones((~c).sum(), np.float32), lab[~c])
               for k, (b, lab, c) in gts.items()}
    assert peval.evaluate_coco_map(perfect, gts, 3)["mAP"] == 1.0


def test_eval_map_and_recalls_match(rng):
    """VOC-style `eval_map` (area and 11-point modes, ignored boxes) and
    `eval_recalls` within 1e-12 of the JAX functions."""
    dets, gts = _dets_and_gts(rng)
    det_results = [[np.concatenate([d[0][d[2] == c], d[1][d[2] == c][:, None]], 1)
                    for c in range(3)] for d in dets.values()]
    anns = [dict(bboxes=b[~cr], labels=lab[~cr], bboxes_ignore=b[cr]) for b, lab, cr in
            gts.values()]
    for mode in ("area", "11points"):
        pm, pr = pmap.eval_map(det_results, anns, 0.5, mode)
        jm, jr = jmap.eval_map(det_results, anns, 0.5, mode)
        assert abs(pm - jm) <= 1e-12 and 0 < pm < 1
        for a, b in zip(pr, jr):
            assert a["num_gts"] == b["num_gts"] and abs(a["ap"] - b["ap"]) <= 1e-12
    props = [np.concatenate([d[0], d[1][:, None]], 1) for d in dets.values()]
    gt_boxes = [g[0] for g in gts.values()]
    thrs = np.arange(0.5, 0.96, 0.05)
    np.testing.assert_allclose(pmap.eval_recalls(gt_boxes, props, (3, 10), thrs),
                               jmap.eval_recalls(gt_boxes, props, (3, 10), thrs),
                               rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def pair():
    """The tiny detector with the RPN's regression scaled by 1/10 in both
    packages: the seeded weights otherwise move every proposal far from
    its anchor, and no proposal would reach IoU 0.5 with a gt."""
    cfg, jm, variables, port = tiny_pair(seed=31)
    reg = variables["params"]["rpn_head"]["rpn_reg"]
    for k in ("kernel", "bias"):
        reg[k] = reg[k] * np.float32(0.1)
    with torch.no_grad():
        for p in port.rpn_head.rpn_reg.parameters():
            p.mul_(0.1)
    return cfg, jm, variables, port


def test_evaluate_dataset_matches_jax(pair, mini_coco):
    """`evaluate_dataset` of the tiny detector at batch 3 over both
    orientations: per image the same detection count, boxes within 1e-2 px
    and scores within 1e-3 after matching rows; the COCO metrics within
    1e-6 of the JAX package's (nan where both are)."""
    cfg, jm, variables, port = pair
    ann, root = mini_coco
    jmet, jdet = japis.evaluate_dataset(jm, variables, jcoco.CocoDataset(ann, root, True),
                                        batch_size=3, scale=SCALE, log_every=0,
                                        return_detections=True)
    pmet, pdet = papis.evaluate_dataset(port, pcoco.CocoDataset(ann, root, True), batch_size=3,
                                        scale=SCALE, log_every=0, return_detections=True)
    assert set(pdet) == set(jdet) == set(range(1, 8))
    assert sum(len(d[1]) for d in pdet.values()) > 0
    for k in jdet:
        assert len(pdet[k][1]) == len(jdet[k][1]), k
        _assert_rows_match_or_tie(*(np.asarray(a) for a in (jdet[k][0], jdet[k][1])),
                                  pdet[k][0], pdet[k][1], np.asarray(jdet[k][2]), pdet[k][2])
    assert set(pmet) == set(jmet)
    for k in jmet:
        assert abs(pmet[k] - jmet[k]) <= 1e-6 or (np.isnan(pmet[k]) and np.isnan(jmet[k])), k


def test_evaluate_proposals_matches_jax(pair, mini_coco):
    """`evaluate_proposals` (AR@10, AR@48 over IoU 0.50:0.95) within 1e-6 of
    the JAX package's at batch 3."""
    cfg, jm, variables, port = pair
    ann, root = mini_coco
    nums = (10, 48)
    j = japis.evaluate_proposals(jm, variables, jcoco.CocoDataset(ann, root, True), batch_size=3,
                                 scale=SCALE, proposal_nums=nums)
    p = papis.evaluate_proposals(port, pcoco.CocoDataset(ann, root, True), batch_size=3,
                                 scale=SCALE, proposal_nums=nums)
    assert set(p) == set(j) == {"AR@10", "AR@48"} and p["AR@48"] > 0
    for k in j:
        assert abs(p[k] - j[k]) <= 1e-6, (k, p[k], j[k])


def test_dcn_offset_stats_match(rng):
    """On the same captured offsets (two calls of three convs, one with
    samples far out of the window), the port's per-conv statistics equal
    those of the JAX package's `_dcn_offset_stats`, key for key."""
    captured_j, captured_p = [], []
    for call in range(2):
        for s, scale in ((2, 0.3), (3, 0.8), (4, 3.0)):
            off = rng.normal(0, scale * (call + 1), (2, 5, 7, 18)).astype(np.float32)
            captured_j.append((f"backbone/layer{s}_0/conv2/conv_offset/__call__", off))
            captured_p.append((f"backbone.layer{s}.0.conv2.conv_offset", off))
    for window in ((-1, 1), (-1, 0)):
        j, _ = japis._dcn_offset_stats(captured_j, window)
        assert papis._dcn_offset_stats(captured_p, window) == j
        assert j["layer4_0"]["flag_rate"] > 0.5


def test_calibrate_dcn_matches_jax(rng):
    """`calibrate_dcn` on the tiny DCN detector (seeded non-zero offset
    convs) and one batch of two images: the JAX function's per-conv keys,
    flag rates and worst flagged pixel counts, and its offset p99 within
    1e-3 of its value (the float32 backbones sum in another order and
    agree to 1e-4 relative, test_torch_backbone). The same images as two
    batches of one aggregate to the same flag rates. The recommendation is
    fixed: the exact kernel has no window or cap."""
    bb = JC.BackboneConfig(depth=10, stage_with_dcn=(False, True, True, True))
    _, jm, variables, port = tiny_pair(seed=8, backbone=bb)
    img = rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    jper, _ = japis.calibrate_dcn(jm, variables, img)
    pper, rec = papis.calibrate_dcn(port, img)
    assert rec == {"impl": "exact", "fb_cap": None}
    assert set(pper) == set(jper) == {"layer2_0", "layer3_0", "layer4_0"}
    assert any(v["flag_rate"] > 0 for v in pper.values())
    for k, v in jper.items():
        assert pper[k]["flag_rate"] == pytest.approx(v["flag_rate"], abs=1e-12)
        assert pper[k]["flagged_px_per_img_p100"] == v["flagged_px_per_img_p100"]
        assert abs(pper[k]["abs_off_p99"] - v["abs_off_p99"]) <= 1e-3 * v["abs_off_p99"]
    split, _ = papis.calibrate_dcn(port, [t(img[:1]), img[1:]])
    for k, v in pper.items():
        assert split[k]["flag_rate"] == pytest.approx(v["flag_rate"], abs=1e-12)
        assert split[k]["flagged_px_per_img_p100"] == v["flagged_px_per_img_p100"]
