"""The port's `apply_overrides` / `dump_config` against the JAX package's
(htd_tpu_torch.config vs htd_tpu.config): the same override strings give
the same resolved config, the same errors, and the same dump of every
preset, on the JAX package's keys (the port's config adds the DetectoRS
fields, which the JAX package lacks)."""

import pytest

from htd_tpu import config as JC
from htd_tpu_torch import config as PC
from tests.torch_port import PORT_ONLY, dump_on_jax_keys

PRESETS = ["htd_r50_1x", "htd_r101_2x", "htd_r101_dcn_2x", "htd_x101_dcn_2x",
           "htd_detectors_r50_1x"]
# the JAX package has no DetectoRS preset: the port's is HTD R-50 1x on its keys
JAX_PRESET = {"htd_detectors_r50_1x": "htd_r50_1x"}
OVERRIDES = [
    "rcnn_test.use_soft_nms=true",        # bool
    "backbone.norm_eval=0",               # bool from a digit
    "roi_extractor.max_samples=8",        # int
    "global_ctx.num_convs=2",
    "train.lr=0.01",                      # float
    "train.lr_steps=16,22",               # tuple of ints
    "fpn.in_channels=64,128,256,512",
    "train.img_scale=96,64",
    "rpn.anchor.ratios=0.5,1,2",          # tuple of floats
    "train.grad_clip_norm=2.5",           # None -> float
    "train.mstrain_range=1600,400",       # None -> tuple of floats
    "train.grad_clip_norm=none",          # float -> None
    "train.rpn_proposal.nms_thr=0.6",     # three levels deep
    "compute_dtype=bfloat16",             # str
    "test_scale=1600,800",
]


@pytest.mark.parametrize("preset", ["htd_r50_1x", "htd_r101_2x"])
def test_apply_overrides_matches_jax(preset):
    """The overrides (bool, int, float, tuple, None, nested paths) give the
    JAX package's `dump_config` JSON, and change what they name."""
    opts = OVERRIDES
    p = PC.apply_overrides(getattr(PC, preset)(), opts)
    j = JC.apply_overrides(getattr(JC, preset)(), opts)
    assert dump_on_jax_keys(PC.dump_config(p)) == JC.dump_config(j)
    assert p.rcnn_test.use_soft_nms is True and p.backbone.norm_eval is False
    assert p.train.lr_steps == (16, 22) and p.train.img_scale == (96, 64)
    assert p.train.grad_clip_norm is None and p.train.mstrain_range == (1600.0, 400.0)
    assert p.train.rpn_proposal.nms_thr == 0.6 and p.compute_dtype == "bfloat16"
    assert p.rpn.anchor.ratios == (0.5, 1.0, 2.0) and p.roi_extractor.max_samples == 8


@pytest.mark.parametrize("option,error", [
    ("train.mstrain_range=1600,400", ValueError),    # nested tuple in the DCN preset
    ("train.nope=1", AttributeError),
    ("nope.lr=1", AttributeError),
])
def test_apply_overrides_raises_as_jax(option, error):
    """A nested tuple and an unknown key raise the same errors in both."""
    for C in (PC, JC):
        with pytest.raises(error):
            C.apply_overrides(C.htd_r101_dcn_2x(), [option])


@pytest.mark.parametrize("preset", PRESETS)
def test_dump_config_matches_jax(preset):
    """The dump of every preset is the JAX package's, character for
    character, on the JAX package's keys; the DetectoRS preset's is HTD
    R-50 1x's there (its heads, RPN, test settings and scale), and its own
    fields are what DetectoRS sets."""
    cfg = getattr(PC, preset)()
    assert dump_on_jax_keys(PC.dump_config(cfg)) == \
        JC.dump_config(getattr(JC, JAX_PRESET.get(preset, preset))())
    port_only = {k: getattr(getattr(cfg, k.split(".")[0]), k.split(".")[1]) for k in PORT_ONLY}
    if preset in JAX_PRESET:
        assert port_only == {"backbone.conv_aws": True,
                             "backbone.stage_with_sac": (False, True, True, True),
                             "fpn.rfp_steps": 2}
    else:
        assert port_only == PORT_ONLY


@pytest.mark.parametrize("option,check", [
    ("train.rcnn.0.sampler.num=32", lambda c: c.train.rcnn[0].sampler.num == 32
     and c.train.rcnn[1].sampler.num == 512),
    ("train.rcnn.1.assigner.pos_iou_thr=0.7", lambda c: c.train.rcnn[1].assigner.pos_iou_thr
     == 0.7 and c.train.rcnn[0].assigner.pos_iou_thr == 0.5),
    ("train.rcnn.1.sampler.add_gt_as_proposals=false",
     lambda c: c.train.rcnn[1].sampler.add_gt_as_proposals is False),
])
def test_apply_overrides_indexes_tuples(option, check):
    """The port's paths may index a tuple of configs (the JAX package's
    cannot): only the indexed element changes, the others stay the
    preset's, and the tuple stays a tuple."""
    base = PC.htd_r50_1x()
    cfg = PC.apply_overrides(base, [option])
    assert check(cfg) and isinstance(cfg.train.rcnn, tuple)
    assert len(cfg.train.rcnn) == len(base.train.rcnn)
    with pytest.raises(IndexError):
        PC.apply_overrides(base, ["train.rcnn.2.sampler.num=1"])
