"""The port's command-line tools (`tools_torch/`) against the JAX
package's (`tools/`), run in process on the CPU: a PNG mini-COCO on disk,
the tiny config put in place of the `htd_r50_1x` preset in both packages,
one `.pth` that both load; get_flops, the production drill, the fidelity
ladder and the launchers at the tiny config."""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import cv2
import numpy as np
import pytest
import torch

from htd_tpu import config as JC
from htd_tpu.models.detector import HTDDetector as JaxDetector
from htd_tpu_torch import config as PC
from htd_tpu_torch.train.checkpoint import save_checkpoint
from htd_tpu_torch.train.optim import make_optimizer
from htd_tpu_torch.train.train_step import TrainState
from tests.test_e2e_parity import _assert_rows_match_or_tie
from tests.torch_port import dump_on_jax_keys, port_config, tiny_pair
from tests.tiny import tiny_config
from tools import coco_error_analysis as jerr
from tools import browse_dataset as jbrowse
from tools import drill_production as jdrill
from tools import get_flops as jflops
from tools import print_config as jprint
from tools import test as jtest
from tools_torch import ab_fidelity as pfidelity
from tools_torch import browse_dataset as pbrowse
from tools_torch import analyze_logs as panalyze
from tools_torch import coco_error_analysis as perr
from tools_torch import drill_production as pdrill
from tools_torch import get_flops as pflops
from tools_torch import eval_metric as pmetric
from tools_torch import print_config as pprint
from tools_torch import test as ptest
from tools_torch import train as ptrain
from tools_torch import train_smoke as psmoke

torch.set_num_threads(1)
# the tools print metrics rounded to 4 places: values within 1e-6 of each
# other (tests/test_torch_eval.py's limit) may round one unit apart
METRIC_LIMIT = 1e-4 + 1e-6


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """Seven PNG images written by cv2 (60x90 landscape, 90x60 portrait),
    two to three annotations each over categories 1 and 3, a box over most
    of the image, one crowd box; the last image without annotations."""
    root = tmp_path_factory.mktemp("pngcoco")
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
                             area=float(bw * bh), iscrowd=int((i, k) == (1, 2))))
        if i < 6:
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                             bbox=[2.0, 1.0, w - 3.0, h - 4.0], area=float((w - 3) * (h - 4)),
                             iscrowd=0))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns, categories=[
        dict(id=1, name="a", supercategory="x"), dict(id=3, name="b", supercategory="x")])))
    return str(ann), str(root)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The tiny detector saved by the port's `save_checkpoint`: its RPN's
    and both stages' box regressions scaled by 1/10, so that proposals and
    detections reach the gts (as in tests/test_torch_eval.py), and both
    stages' logits of the dataset's two classes (labels 0 and 1) raised, so
    that detections carry their labels."""
    _, _, _, port = tiny_pair(seed=31)
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


def _run_jax_tool(module, argv, monkeypatch, capsys):
    """Run a JAX tool's `main()` with `argv`; its last printed line."""
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.strip().splitlines()[-1]


def _assert_metrics_close(p, j):
    assert set(p) == set(j)
    for k in j:
        assert abs(p[k] - j[k]) <= METRIC_LIMIT or (np.isnan(p[k]) and np.isnan(j[k])), (k, p, j)


@pytest.mark.parametrize("mode", ["bbox", "proposal"])
def test_test_tool_matches_jax(mini_coco, checkpoint, tiny_presets, monkeypatch, capsys, tmp_path,
                               mode):
    """tools_torch/test.py and tools/test.py on the same `.pth` print the
    same metrics JSON, each metric within 1e-4 (+1e-6) (COCO bbox, with
    --dump and --coco-dump, or the RPN's recalls); their --dump detections
    agree per image (the same count, boxes within 1e-2 px and scores 1e-3
    after matching rows); eval_metric.py on the port's dump prints the
    port's metrics; coco_error_analysis.py gives the JAX tool's curves on
    the port's COCO dump."""
    ann, root = mini_coco
    args = ["--checkpoint", checkpoint, "--ann", ann, "--img-root", root, "--batch-size", "3",
            "--scale", "96x64", "--eval", mode]
    jargs, pargs = args, args
    if mode == "bbox":
        jargs = args + ["--dump", str(tmp_path / "j.json"),
                        "--coco-dump", str(tmp_path / "jc.json")]
        pargs = args + ["--dump", str(tmp_path / "p.json"),
                        "--coco-dump", str(tmp_path / "pc.json")]
    j = json.loads(_run_jax_tool(jtest, jargs, monkeypatch, capsys))
    p = ptest.main(pargs + ["--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(p)
    _assert_metrics_close(p, j)
    if mode == "proposal":
        assert set(p) == {"AR@100", "AR@300", "AR@1000"} and p["AR@1000"] > 0
        return
    assert p["mAP_50"] > 0
    jd, pd = (json.load(open(tmp_path / f)) for f in ("j.json", "p.json"))
    assert set(pd) == set(jd) == {str(i) for i in range(1, 8)}
    for k in jd:
        a, b = jd[k], pd[k]
        assert len(a["scores"]) == len(b["scores"]), k
        if a["scores"]:
            _assert_rows_match_or_tie(*(np.asarray(a[f]) for f in ("boxes", "scores")),
                                      *(np.asarray(b[f]) for f in ("boxes", "scores")),
                                      np.asarray(a["labels"]), np.asarray(b["labels"]))
    assert json.dumps(pmetric.main([str(tmp_path / "p.json"), "--ann", ann])) == json.dumps(p)
    coco = json.load(open(tmp_path / "pc.json"))
    assert coco and {r["category_id"] for r in coco} <= {1, 3}
    jc = jerr.analyze_results(str(tmp_path / "pc.json"), ann, str(tmp_path / "jerr"))
    pc = perr.main([str(tmp_path / "pc.json"), str(tmp_path / "perr"), "--ann", ann])
    assert pc.shape == (7, 101, 4) and pc[1].max() > 0
    np.testing.assert_allclose(pc, jc, rtol=0, atol=1e-12)


@pytest.mark.parametrize("preset", ["htd_r50_1x", "htd_x101_dcn_2x"])
def test_print_config_matches_jax(preset, monkeypatch, capsys):
    """tools_torch/print_config.py prints tools/print_config.py's text on the
    JAX package's keys; the port's config adds only the DetectoRS fields,
    at their defaults (`tests/torch_port.PORT_ONLY`)."""
    monkeypatch.setattr(sys, "argv", ["print_config.py", preset])
    jprint.main()
    j = capsys.readouterr().out
    p = pprint.main([preset])
    assert p + "\n" == capsys.readouterr().out
    assert dump_on_jax_keys(p) + "\n" == j


def test_train_resume_is_bit_exact(mini_coco, tiny_presets, tmp_path):
    """tools_torch/train.py over 2 epochs equals, bit for bit on the CPU,
    its first epoch then --resume-from epoch_1.pth: the second epoch's log
    lines (but their time) and every tensor and momentum buffer of
    epoch_2.pth. The log lines carry the JAX tool's keys; config.json is
    the resolved config's dump; --val-ann reports the validation metrics
    after the epoch; analyze_logs.py plots the log."""
    ann, root = mini_coco
    args = ["--train-ann", ann, "--train-img", root, "--batch-size", "2", "--log-interval", "1",
            "--seed", "3", "--device", "cpu", "--set", "train.img_scale=96,64",
            "test_scale=96,64", "train.total_epochs=2"]
    logs = ptrain.main(args + ["--work-dir", str(tmp_path / "full")])
    resumed = ptrain.main(args + ["--work-dir", str(tmp_path / "resumed"), "--val-ann", ann,
                                  "--val-img", root,
                                  "--resume-from", str(tmp_path / "full" / "epoch_1.pth")])
    keys = set(JaxDetector(tiny_config()).loss_keys()) | {"loss", "epoch", "iter", "time"}
    assert [(r["epoch"], r["iter"]) for r in logs] == [(1, 1), (1, 2), (2, 1), (2, 2)]
    assert all(set(r) == keys and np.isfinite(r["loss"]) for r in logs)
    drop = lambda r: {k: v for k, v in r.items() if k != "time"}  # noqa: E731
    assert [drop(r) for r in resumed[:-1]] == [drop(r) for r in logs[2:]]
    val = resumed[-1]
    assert val["epoch"] == 2 and set(val) == {"epoch", "mAP", "mAP_50", "mAP_75", "mAP_s",
                                              "mAP_m", "mAP_l", "AR@100"}
    log = tmp_path / "full" / "train.log.json"
    with open(log) as f:
        assert [json.loads(line) for line in f] == logs
    png = tmp_path / "curves.png"
    assert panalyze.main([str(log), "--keys", "loss", "s0.loss_cls", "--out", str(png)]) == \
        [f"saved {png}"]
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    cfg = json.loads((tmp_path / "resumed" / "config.json").read_text())
    assert cfg["train"]["total_epochs"] == 2 and cfg["train"]["img_scale"] == [96, 64]

    a = torch.load(tmp_path / "full" / "epoch_2.pth", weights_only=True)
    b = torch.load(tmp_path / "resumed" / "epoch_2.pth", weights_only=True)
    assert a["meta"] == b["meta"] and a["meta"]["step"] == 4 and a["meta"]["epoch"] == 2
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for i, st in a["optimizer"]["state"].items():
        assert torch.equal(st["momentum_buffer"], b["optimizer"]["state"][i]["momentum_buffer"])


@pytest.mark.parametrize("tool", ["train", "test", "train_smoke"])
def test_tools_need_a_device(mini_coco, tiny_presets, monkeypatch, tmp_path, tool):
    """Without CUDA the tools that run the model raise unless --device cpu
    is given; train_smoke.py runs on the CPU when asked."""
    ann, root = mini_coco
    module, argv = {
        "train": (ptrain, ["--train-ann", ann, "--train-img", root, "--batch-size", "2",
                           "--work-dir", str(tmp_path)]),
        "test": (ptest, ["--ann", ann, "--img-root", root]),
        "train_smoke": (psmoke, ["--steps", "2", "--height", "64", "--width", "96"]),
    }[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    if tool == "train_smoke":
        records = psmoke.main(argv + ["--device", "cpu", "--log-every", "1"])
        assert [r["iter"] for r in records[:2]] == [0, 1] and np.isfinite(records[-1]["last"])


# the tiny config's inference fields as command-line overrides, for the tools
# that run test.py as a process of its own (weights: backbone.depth alone)
TINY_SET = ["backbone.depth=10", "proposal_test.nms_pre=64", "proposal_test.nms_post=48",
            "proposal_test.max_num=48", "rcnn_test.max_per_img=10"]


def test_get_flops(tiny_presets, monkeypatch, capsys):
    """get_flops.py at the tiny config on the CPU: params equal to
    sum(p.numel()); FlopCounterMode's convolution and addmm FLOPs within 1%
    of an analytic count of the model's convs and linears (forward hooks on
    the same run); printed beside the JAX tool's XLA estimate on the CPU."""
    from htd_tpu_torch.apis import init_detector

    analytic = {"conv": 0, "linear": 0}

    def hook(m, args, out):
        if isinstance(m, torch.nn.Conv2d):
            analytic["conv"] += 2 * out.numel() * m.in_channels // m.groups * \
                m.kernel_size[0] * m.kernel_size[1]
        else:
            analytic["linear"] += 2 * out.numel() * m.in_features

    handles = []
    register = torch.nn.Module.register_forward_hook

    def build(cfg, checkpoint=None, device=None, seed=0):
        model = init_detector(cfg, checkpoint, device, seed)
        handles.extend(register(m, hook) for m in model.modules()
                       if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)))
        return model

    monkeypatch.setattr("htd_tpu_torch.apis.init_detector", build)
    out = pflops.main(["--device", "cpu", "--height", "64", "--width", "96"])
    model = build(PC.htd_r50_1x(), device="cpu")
    assert out["params"] == sum(p.numel() for p in model.parameters())
    # the hooks saw two calls: the warm one and the counted one
    for op, kind in (("aten.convolution", "conv"), ("aten.addmm", "linear")):
        assert abs(out["aten"][op] - analytic[kind] / 2) <= 0.01 * analytic[kind] / 2, op
    assert out["calls"] == {"deform_conv": 0, "roi_align": 3} and out["roi_align"] > 0
    line = _run_jax_tool(jflops, ["--height", "64", "--width", "96"], monkeypatch, capsys)
    xla = float(line.split(":")[1].split()[0]) * 1e9
    print(f"\nport {out['total'] / 1e9:.3f} GFLOPs (FlopCounterMode {out['aten_total'] / 1e9:.3f} "
          f"+ K2 {out['roi_align'] / 1e9:.3f}), JAX tool's XLA estimate {xla / 1e9:.3f} GFLOPs, "
          f"ratio {out['total'] / xla:.3f}")
    assert np.isfinite(xla) and xla > 0


def _in_process(cmd, env=None):
    """drill_production's `_run` in this process: the tool that `cmd` names
    run by its `main(argv)` (so that the patched presets reach it), its
    standard output captured; returns (the output, wall seconds)."""
    module = {"test.py": ptest, "coco_error_analysis.py": perr}[os.path.basename(cmd[1])]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        module.main(cmd[2:])
    return buf.getvalue(), time.perf_counter() - t0


def test_drill_production_small(tiny_presets, tmp_path, monkeypatch):
    """drill_production.py --images 4 --mirror-images 1 at the tiny config
    (16 proposals) and 192x128 on the CPU: its steps pass (test.py and
    coco_error_analysis.py run in this process, the parity subset, the
    matcher's two timings with equal metrics), and make_dataset's PNG
    files decode equal to the JAX tool's cv2 images with the same
    annotations."""
    monkeypatch.setattr(PC, "htd_r50_1x", lambda: port_config(tiny_config(
        proposal_test=JC.ProposalConfig(nms_pre=64, nms_post=16, max_num=16))))
    monkeypatch.setattr(pdrill, "_run", _in_process)
    out = pdrill.main(["--images", "4", "--mirror-images", "1", "--scale", "192x128",
                       "--device", "cpu", "--out", str(tmp_path / "p"), "--cls-std", "0.3"])
    assert out["matched"] >= 10 and out["box_mad_px"] <= 2.0 and out["score_mad"] <= 0.02
    assert out["error_analysis_plots"] > 0 and out["matcher_s"] > 0 and out["matcher_plain_s"] > 0
    ann_j, dir_j, _ = jdrill.make_dataset(str(tmp_path / "j"), 4, np.random.RandomState(0))
    with open(tmp_path / "p" / "ann.json") as f, open(ann_j) as g:
        assert json.load(f) == json.load(g)
    for name in sorted(os.listdir(dir_j)):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p" / "images" / name)),
                                      cv2.imread(os.path.join(dir_j, name)), err_msg=name)


# tools/ab_fidelity.py's JSON keys
FIDELITY_KEYS = {"n_ref", "n_cur", "matched", "ref_only", "cur_only", "score_mad", "score_max",
                 "box_mad_px", "box_max_px", "ms_per_img"}
PRE_NMS_KEYS = {"score_mad", "score_p99", "score_max", "box_mad_px", "box_p99_px",
                "box_max_px", "score_mad_elongated", "score_mad_square"}


@pytest.mark.parametrize("pre_nms", [False, True])
def test_ab_fidelity_two_rungs(pre_nms, tiny_presets, monkeypatch):
    """ab_fidelity.py with two rungs at the tiny config on the CPU (one timed
    call each, 100 pre-NMS rois, classifiers spread for detections) writes
    the JAX tool's JSON keys (ms_per_img added to the pre-NMS rungs), the
    highest rung as the reference, equal to itself."""
    for name, value in (("LADDER", [(4, 1), (6, 2)]), ("PRE_NMS_LADDER", [(4, 1), (6, 2)]),
                        ("PRE_NMS_ROIS", 100), ("CLS_STD", 0.3), ("WARMUP_CALLS", 0),
                        ("TIMED_CALLS", 1)):
        monkeypatch.setattr(pfidelity, name, value)
    out = pfidelity.main(["--device", "cpu", "--height", "64", "--width", "96", "--dtype",
                          "float32"] + (["--pre-nms"] if pre_nms else []))
    assert out["reference_rung"] == [6, 2] and set(out["rungs"]) == {"4,1", "6,2"}
    if pre_nms:
        assert {k for k in out if k != "rungs"} == {"mode", "reference_rung", "dtype", "n_rois",
                                                      "n_elongated_gt2"}
        assert all(set(r) == PRE_NMS_KEYS | {"ms_per_img"} for r in out["rungs"].values())
        assert out["rungs"]["6,2"]["score_max"] == 0.0 and out["n_rois"] == 100
    else:
        assert {k for k in out if k != "rungs"} == {"reference_rung", "dtype"}
        assert all(set(r) == FIDELITY_KEYS for r in out["rungs"].values())
        ref = out["rungs"]["6,2"]
        assert ref["matched"] == ref["n_ref"] > 0 and ref["score_max"] == 0.0


def test_dist_launchers(mini_coco, checkpoint, monkeypatch, tmp_path):
    """tools_torch/dist_train.sh and dist_test.sh pass `bash -n`;
    dist_test.sh with one chip on the CPU (gloo) writes the same raw
    detections, bit for bit, and prints the same metrics as
    tools_torch/test.py run as a process with the same arguments."""
    for script in ("dist_train.sh", "dist_test.sh"):
        subprocess.run(["bash", "-n", f"tools_torch/{script}"], check=True)
    ann, root = mini_coco
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = ["--ann", ann, "--img-root", root, "--scale", "96x64", "--batch-size", "2",
            "--max-images", "2", "--fast", "--device", "cpu", "--dist-backend", "gloo",
            "--set", *TINY_SET]
    printed, dumps = [], []
    for i, cmd in enumerate((["bash", "tools_torch/dist_test.sh", "htd_r50_1x", checkpoint, "1"],
                             [sys.executable, "tools_torch/test.py", "--checkpoint",
                              checkpoint])):
        dump = tmp_path / f"dump{i}.json"
        done = subprocess.run(cmd + args + ["--dump", str(dump)],
                              env=dict(os.environ, PYTHON=sys.executable),
                              capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-2000:]
        printed.append(json.loads(done.stdout.strip().splitlines()[-1]))
        dumps.append(dump.read_text())
    assert dumps[0] == dumps[1] and printed[0] == printed[1]
    dets = json.loads(dumps[0])
    assert len(dets) == 2 and all(len(d["scores"]) for d in dets.values())


@pytest.fixture(scope="module")
def browse_coco(tmp_path_factory):
    """Two JPEG and two PNG images written by cv2 (60x90 landscape, 90x61
    portrait), boxes over categories 1 and 3 that cross the image's edges,
    the last image without annotations (which the training set leaves out)."""
    root = tmp_path_factory.mktemp("browsecoco")
    rng = np.random.RandomState(3)
    images, anns = [], []
    for i in range(4):
        h, w = (60, 90) if i % 2 == 0 else (90, 61)
        name = f"img{i}.{'jpg' if i < 2 else 'png'}"
        cv2.imwrite(str(root / name), rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=i + 1, file_name=name, height=h, width=w))
        for _ in range(0 if i == 3 else 3):
            x, y = rng.uniform(-6, w / 2), rng.uniform(-6, h / 2)
            bw, bh = rng.uniform(8, w / 1.5), rng.uniform(8, h / 1.5)
            anns.append(dict(id=len(anns) + 1, image_id=i + 1, category_id=int(rng.choice([1, 3])),
                             bbox=[float(x), float(y), float(bw), float(bh)],
                             area=float(bw * bh), iscrowd=0))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns, categories=[
        dict(id=1, name="person"), dict(id=3, name="car")])))
    return str(ann), str(root)


@pytest.mark.parametrize("mode", [[], ["--raw"], ["--corruption", "gaussian_noise", "--severity",
                                                 "2"],
                                  ["--scale", "128x96", "--max-images", "2", "--seed", "5"]],
                         ids=["pipeline", "raw", "corruption", "scale-max-images"])
def test_browse_dataset_matches_jax(mode, browse_coco, monkeypatch, tmp_path):
    """tools_torch/browse_dataset.py --device cpu writes the files that
    tools/browse_dataset.py writes for the same options: .jpg byte for byte,
    .png with the same pixels (the train pipeline at the config's scale,
    the raw images, a corruption, another scale with --max-images)."""
    ann, root = browse_coco
    base = ["--ann", ann, "--img-root", root]
    monkeypatch.setattr(sys, "argv", ["tool"] + base + ["--output-dir", str(tmp_path / "jax")]
                        + mode)
    jbrowse.main()
    written = pbrowse.main(base + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]
                           + mode)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.path.basename(f) for f in written) == names
    assert len(names) == (2 if "--max-images" in mode else 3)   # training drops img3
    for name in names:
        ours, theirs = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(str(ours)), cv2.imread(str(theirs)))
        else:
            assert ours.read_bytes() == theirs.read_bytes(), name


def test_browse_dataset_needs_a_device(browse_coco, tmp_path, monkeypatch):
    """Without --device the tool runs on CUDA, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ann, root = browse_coco
    with pytest.raises(RuntimeError, match="CUDA"):
        pbrowse.main(["--ann", ann, "--img-root", root, "--output-dir", str(tmp_path)])
