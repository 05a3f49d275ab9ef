"""The port's robustness tools (`tools_torch/test_robustness.py`,
`tools_torch/robustness_eval.py`) against the JAX package's, in process on
the CPU: a JPEG mini-COCO on disk, the tiny config in place of the
`htd_r50_1x` preset in both packages, one `.pth` that both load."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from htd_tpu import config as JC
from htd_tpu_torch import config as PC
from htd_tpu_torch.apis import evaluate_dataset, init_detector
from htd_tpu_torch.data.coco import CocoDataset
from htd_tpu_torch.train.checkpoint import save_checkpoint
from htd_tpu_torch.train.optim import make_optimizer
from htd_tpu_torch.train.train_step import TrainState
from tests.jpeg_fixtures import cv2_jpeg, pattern, pil_jpeg
from tests.tiny import tiny_config
from tests.torch_port import port_config
from tools import robustness_eval as jeval
from tools import test_robustness as jtool
from tools_torch import robustness_eval as peval
from tools_torch import test_robustness as ptool

torch.set_num_threads(1)
TOOLS = str(Path(jtool.__file__).resolve().parent)
# one batch of the four images per cell, 32 proposals per image (the tiny
# model's BA regression convs dominate its time, in proportion to the rois;
# fewer proposals leave it no detection that scores)
COMMON = ["--scale", "96x64", "--batch-size", "4", "--corruptions", "gaussian_noise",
          "jpeg_compression", "--severities", "0", "1", "--seed", "3", "--final-prints", "P",
          "mPC", "rPC", "--set", "proposal_test.nms_post=32", "proposal_test.max_num=32"]


@pytest.fixture(scope="module")
def jpeg_coco(tmp_path_factory):
    """Four landscape JPEG files (OpenCV's and PIL's, one of them 4:2:2),
    with three to four boxes each over categories 1 and 3."""
    root = tmp_path_factory.mktemp("jpegcoco")
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(4):
        h, w = (60, 90) if i % 2 == 0 else (57, 85)
        img = pattern(i, h, w)
        (root / f"{i}.jpg").write_bytes(cv2_jpeg(img, 90, 422 if i == 1 else 420) if i < 2
                                        else pil_jpeg(img, quality=90))
        images.append(dict(id=i + 1, file_name=f"{i}.jpg", height=h, width=w))
        for _ in range(2 + i % 2):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=int(rng.choice([1, 3])),
                             bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0))
        anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                         bbox=[2.0, 1.0, w - 3.0, h - 4.0], area=(w - 3.0) * (h - 4.0),
                         iscrowd=0))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns, categories=[
        dict(id=1, name="a"), dict(id=3, name="b")])))
    return str(ann), str(root)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny detector (the port's random init) saved by the port, its box
    regressions scaled by 1/10 and the dataset's two classes' logits raised
    (as tests/test_torch_tools.py does), so that detections reach the gts."""
    port = init_detector(port_config(tiny_config()), device="cpu", seed=31)
    with torch.no_grad():
        for m in (port.rpn_head.rpn_reg, *(h.fc_reg for h in port.roi_head.bbox_head)):
            for p in m.parameters():
                p.mul_(0.1)
        for head in port.roi_head.bbox_head:
            head.fc_cls.bias[:2] += 3.0
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    save_checkpoint(path, TrainState(port, make_optimizer(port.cfg.train, port), 0, 1))
    return path


@pytest.fixture
def tiny_presets(monkeypatch):
    monkeypatch.setattr(JC, "htd_r50_1x", tiny_config)
    monkeypatch.setattr(PC, "htd_r50_1x", lambda: port_config(tiny_config()))


def _close(a, b):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= 1e-6 or (math.isnan(a) and math.isnan(b))


def _tools_agree(common, names, jpeg_coco, checkpoint, tmp_path, monkeypatch, capsys):
    """Runs both tools with `common` arguments; checks the json layouts,
    metrics within 1e-6 and printed P / mPC / rPC; returns the port's json
    and what it printed."""
    ann, root = jpeg_coco
    args = ["--checkpoint", checkpoint, "--ann", ann, "--img-root", root] + common
    monkeypatch.syspath_prepend(TOOLS)     # the JAX tool imports robustness_eval from tools/
    monkeypatch.setattr(sys, "argv", ["test_robustness.py", *args, "--out",
                                      str(tmp_path / "j.json")])
    jtool.main()
    jprinted = capsys.readouterr().out.split("\nmodel:")[-1]
    printed = ptool.main(args + ["--out", str(tmp_path / "p.json"), "--device", "cpu"])
    assert capsys.readouterr().out.split("\nmodel:")[-1].replace("p.json", "j.json") == jprinted
    j, p = (json.loads((tmp_path / f).read_text()) for f in ("j.json", "p.json"))
    assert list(p) == list(j) == names
    for corruption in j:
        assert list(p[corruption]) == list(j[corruption]) == ["0", "1"]
        for sev in j[corruption]:
            pm, jm = p[corruption][sev]["bbox"], j[corruption][sev]["bbox"]
            assert list(pm) == list(jm)
            assert all(_close(pm[k], jm[k]) for k in jm), (corruption, sev, pm, jm)
    assert p[names[1]]["0"] == p[names[0]]["0"]
    return p, printed


def _clean_metrics(common, ann, root, checkpoint):
    cfg = PC.apply_overrides(PC.htd_r50_1x(), common[common.index("--set") + 1:])
    model = init_detector(cfg, checkpoint, device="cpu")
    return evaluate_dataset(model, CocoDataset(ann, root, test_mode=True), batch_size=4,
                            scale=(96, 64))


def test_tool_matches_jax(jpeg_coco, checkpoint, tiny_presets, tmp_path, monkeypatch, capsys):
    """tools_torch/test_robustness.py --device cpu writes the JAX tool's
    json layout (the same corruptions, severities and metric keys, severity
    0 evaluated once and shared) with its metrics within 1e-6; its severity
    0 equals `evaluate_dataset` on the clean set; both print the same P /
    mPC / rPC."""
    p, printed = _tools_agree(COMMON, ["gaussian_noise", "jpeg_compression"], jpeg_coco,
                              checkpoint, tmp_path, monkeypatch, capsys)
    clean = _clean_metrics(COMMON, *jpeg_coco, checkpoint)
    assert p["gaussian_noise"]["0"]["bbox"] == {k: None if v != v else v
                                                for k, v in clean.items()}
    assert clean["mAP_50"] > 0
    assert set(printed) == {"P", "mPC", "rPC"}
    assert printed["P"]["mAP"] == pytest.approx(clean["mAP"], abs=0)


def test_tool_matches_jax_blur_elastic(jpeg_coco, checkpoint, tiny_presets, tmp_path, monkeypatch,
                                       capsys):
    """The same with a blur and `elastic_transform` (OpenCV's float32
    filters and warps, the port's own copies) at severities 0 and 1."""
    common = COMMON[:COMMON.index("--corruptions") + 1] + ["motion_blur", "elastic_transform"] \
        + COMMON[COMMON.index("--severities"):]
    p, _ = _tools_agree(common, ["motion_blur", "elastic_transform"], jpeg_coco, checkpoint,
                        tmp_path, monkeypatch, capsys)
    clean = _clean_metrics(common, *jpeg_coco, checkpoint)
    assert p["motion_blur"]["0"]["bbox"] == {k: None if v != v else v for k, v in clean.items()}
    assert p["motion_blur"]["1"] != p["motion_blur"]["0"]


@pytest.mark.parametrize("aggregate", ["benchmark", "all"])
def test_robustness_eval_matches_jax(tmp_path, capsys, aggregate):
    """`get_results` of both packages on one json (a holdout corruption,
    null metrics, P = 0 for one metric): the same dict and the same text."""
    rng = np.random.RandomState(4)
    keys = peval.METRICS
    data = {}
    for c in ("fog", "saturate", "contrast"):
        data[c] = {str(s): {"bbox": {k: float(rng.uniform(0.1, 0.6)) for k in keys}}
                   for s in range(6)}
    data["fog"]["0"]["bbox"]["mAP_s"] = None
    data["fog"]["0"]["bbox"]["mAP_l"] = 0.0
    data["contrast"]["3"]["bbox"]["mAP_m"] = None
    path = tmp_path / "r.json"
    path.write_text(json.dumps(data))
    j = jeval.get_results(str(path), prints="all", aggregate=aggregate)
    jtext = capsys.readouterr().out
    p = peval.main([str(path), "--prints", "P", "mPC", "rPC", "--aggregate", aggregate])
    assert capsys.readouterr().out == jtext
    assert p.keys() == j.keys()
    for k in j:
        assert p[k].keys() == j[k].keys()
        for m in j[k]:
            assert p[k][m] == j[k][m] or (math.isnan(p[k][m]) and math.isnan(j[k][m])), (k, m)


@pytest.mark.parametrize("names", [["gaussian_noise", "motion_blurr"], ["blurs"],
                                   ["all", "no_such"]])
def test_unknown_corruption_fails_first(names, tmp_path, monkeypatch, capsys):
    """A name that is neither a corruption nor a group fails at once, naming
    it, before a model is built or an image read."""
    import htd_tpu_torch.apis as apis

    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(apis, "init_detector", no_model)
    with pytest.raises(SystemExit):
        ptool.main(["--ann", str(tmp_path / "missing.json"), "--out", str(tmp_path / "o.json"),
                    "--device", "cpu", "--corruptions", *names])
    err = capsys.readouterr().err
    assert f"unknown corruption {names[-1]!r}" in err
    assert not (tmp_path / "o.json").exists()
