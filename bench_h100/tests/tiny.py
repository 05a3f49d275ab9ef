"""A tiny configuration of the benchmark for CPU tests: the published
layer kinds at depth 10 and small RoI counts, as a configuration file's
dict (no preset: it is nobody's published config)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
TINY = {
    "backbone": {"depth": 10},
    "proposal_test": {"nms_pre": 64, "nms_post": 48, "max_num": 48},
    "rcnn_test": {"max_per_img": 10},
    "train": {"rpn_proposal": {"nms_pre": 64, "nms_post": 48, "max_num": 48},
              "rpn_sampler": {"num": 32, "pos_fraction": 0.5, "add_gt_as_proposals": False},
              "max_gt": 8, "rcnn_pos_cap": 8},
    "test_scale": [160, 96],
}


def _merge(base: dict, over: dict) -> dict:
    for k, v in over.items():
        if isinstance(v, dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def tiny_doc(config: str = "htd_r50_1x", dtype: str = "float32", **extra) -> dict:
    """The named configuration file cut to the tiny sizes, in `dtype`."""
    doc = json.loads((CONFIGS / f"{config}.json").read_text())
    doc.pop("preset")
    doc.pop("overrides")
    cfg = _merge(copy.deepcopy(doc["config"]), TINY)
    for st in cfg["train"]["rcnn"]:
        st["sampler"]["num"] = 32
    cfg["compute_dtype"] = dtype
    doc["config"] = _merge(cfg, extra)
    if cfg["backbone"]["stage_with_dcn"][1]:
        doc["assumed"]["offset_weight_std"] = [0.01] * 3
    return doc
