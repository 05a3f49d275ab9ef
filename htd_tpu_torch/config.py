"""Typed configuration for htd_tpu_torch.

A framework-free copy of the JAX package's configuration dataclasses and
presets, kept here so that the port imports nothing of `htd_tpu`. A test
holds every shared preset's `dataclasses.asdict` equal to the JAX
package's on the JAX package's keys, so the two copies cannot drift. The
presets transcribe the HTD configs:
  * htd_r50_1x           <- configs/htd/htd_resnet50_1x.py
  * htd_r101_2x          <- configs/htd/htd_resnet101_2x.py
  * htd_r101_dcn_2x      <- configs/htd/htd_resnet101_dcn_2x_mstrain.py
  * htd_x101_dcn_2x      <- configs/htd/htd_resnetx101_dcn_2x_mstrain.py
The port has one preset more, which the JAX package lacks:
  * htd_detectors_r50_1x <- htd_resnet50_1x.py's heads under the backbone
    and neck of mmdetection v2.7.0's
    configs/detectors/detectors_cascade_rcnn_r50_1x_coco.py (DetectoRS:
    weight-standardised convs, switchable atrous convs, a recursive
    feature pyramid).
The fields that only that preset sets (`BackboneConfig.conv_aws`,
`stage_with_sac`; `FPNConfig.rfp_steps`) are not in the JAX package's
dataclasses; the test compares the other fields and holds these at their
defaults in the four shared presets.
`apply_overrides` and `dump_config`, the tools' `--set` options and their
`config.json`, are copies of the JAX package's too.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    depth: int = 50                      # 50 | 101
    groups: int = 1                      # >1 => ResNeXt
    base_width: int = 4                  # ResNeXt bottleneck width multiplier
    num_stages: int = 4
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    frozen_stages: int = 1               # stem + stages[:frozen] frozen
    norm_eval: bool = True               # BN uses frozen running stats
    stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)
    dcn_deform_groups: int = 1
    base_planes: int = 64                # stage-1 width (tests/dryruns shrink)
    # DetectoRS (port only): every conv weight-standardised (mmcv ConvAWS2d);
    # conv2 of the stages that ask for it a deformable switchable atrous
    # conv (mmcv SAConv2d with use_deform)
    conv_aws: bool = False
    stage_with_sac: Tuple[bool, ...] = (False, False, False, False)


@dataclass(frozen=True)
class FPNConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5                    # P2-P5 + P6 (maxpool of P5)
    # DetectoRS's recursive feature pyramid (port only): 1 = a plain FPN;
    # n > 1 runs n - 1 further backbones fed back through ASPP
    rfp_steps: int = 1


@dataclass(frozen=True)
class AnchorConfig:
    scales: Tuple[float, ...] = (8,)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)


@dataclass(frozen=True)
class BoxCoderConfig:
    means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    stds: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)


@dataclass(frozen=True)
class RPNConfig:
    in_channels: int = 256
    feat_channels: int = 256
    anchor: AnchorConfig = AnchorConfig()
    coder: BoxCoderConfig = BoxCoderConfig()
    loss_bbox_beta: float = 1.0 / 9.0


@dataclass(frozen=True)
class ProposalConfig:
    """RPN proposal generation (train `rpn_proposal` / test `rpn` cfg)."""

    nms_pre: int = 1000                  # per-level pre-NMS top-k
    nms_post: int = 1000                 # post-NMS cap (= proposal capacity)
    max_num: int = 1000
    nms_thr: float = 0.7
    min_bbox_size: float = 0.0


@dataclass(frozen=True)
class AssignerConfig:
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.5
    min_pos_iou: float = 0.5
    match_low_quality: bool = False


@dataclass(frozen=True)
class SamplerConfig:
    num: int = 512
    pos_fraction: float = 0.25
    add_gt_as_proposals: bool = True


@dataclass(frozen=True)
class StageTrainConfig:
    assigner: AssignerConfig = AssignerConfig()
    sampler: SamplerConfig = SamplerConfig()
    pos_weight: float = -1.0


@dataclass(frozen=True)
class BBoxHeadConfig:
    in_channels: int = 256
    fc_out_channels: int = 1024
    roi_feat_size: int = 7
    num_classes: int = 80
    coder: BoxCoderConfig = BoxCoderConfig(stds=(0.1, 0.1, 0.2, 0.2))
    reg_class_agnostic: bool = True
    loss_bbox_beta: float = 1.0


@dataclass(frozen=True)
class HTDHeadConfig(BBoxHeadConfig):
    """Stage-1 heterogeneous head (PGraph cls + BA reg).

    Defaults transcribe htd_bbox_head.py:34-51 + the config overrides.
    """

    coder: BoxCoderConfig = BoxCoderConfig(stds=(0.05, 0.05, 0.1, 0.1))
    num_cls_fcs: int = 2
    num_reg_convs: int = 4
    reg_mid_channels: int = 576          # 16 * 36
    reg_out_channels: int = 1024
    gn_groups: int = 36
    alpha: float = 1.0
    edge: int = 1
    replace_mode: bool = False           # cfg `relpace` (sic) — zero the ring
    average_mode: bool = False


@dataclass(frozen=True)
class GlobalContextConfig:
    """SFA head; built inline by the reference (htd_roi_head.py:61-71)."""

    num_convs: int = 4
    in_channels: int = 256
    conv_out_channels: int = 256
    loss_weight: float = 3.0


@dataclass(frozen=True)
class RoIExtractorConfig:
    out_size: int = 7
    sampling_ratio: int = 0              # 0 = adaptive (mmcv semantics)
    max_samples: int = 4                 # static clamp of the adaptive grid
    # Selects the JAX package's RoIAlign implementation (auto, pallas,
    # pallas_v3, pallas_v4 or gather); kept so that the two configs stay
    # field-for-field equal. The port maps every name onto its one
    # RoIAlign (the CUDA kernel on CUDA tensors, its plain version on CPU
    # tensors) and rejects any other name.
    impl: str = "auto"
    # The BA extractor aligns every roi on every level. The roi's OWN level
    # reuses the exact SingleRoIExtractor features (computed anyway by the
    # cascade); only the off-target levels are sampled here, and those are
    # inherently approximate (the true adaptive grid would be up to ~48),
    # so they get the minimal clamp — 8x less gather traffic than exact.
    adpt_max_samples: int = 1
    featmap_strides: Tuple[int, ...] = (4, 8, 16, 32)
    finest_scale: float = 56.0
    adpt_edge: int = 1                   # AdptRoIExtractor border-ring width


@dataclass(frozen=True)
class RCNNTestConfig:
    score_thr: float = 0.05
    nms_iou: float = 0.5
    max_per_img: int = 100
    use_soft_nms: bool = False
    soft_min_score: float = 0.05


@dataclass(frozen=True)
class TrainConfig:
    # RPN anchor training
    rpn_assigner: AssignerConfig = AssignerConfig(
        pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3, match_low_quality=True
    )
    rpn_sampler: SamplerConfig = SamplerConfig(
        num=256, pos_fraction=0.5, add_gt_as_proposals=False
    )
    rpn_allowed_border: float = 0.0
    rpn_proposal: ProposalConfig = ProposalConfig(
        nms_pre=2000, nms_post=2000, max_num=2000
    )
    # two RCNN stages
    rcnn: Tuple[StageTrainConfig, ...] = (
        StageTrainConfig(
            assigner=AssignerConfig(0.5, 0.5, 0.5, False),
            sampler=SamplerConfig(512, 0.25, True),
        ),
        StageTrainConfig(
            assigner=AssignerConfig(0.6, 0.6, 0.6, False),
            sampler=SamplerConfig(512, 0.25, True),
        ),
    )
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5)
    # static capacities
    max_gt: int = 100                    # padded GT boxes per image
    rcnn_pos_cap: int = 128              # = num * pos_fraction
    # optimization (schedule_1x / 2x)
    lr: float = 0.02
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    lr_steps: Tuple[int, ...] = (8, 11)  # epochs (1x); 2x = (16, 22)
    total_epochs: int = 12
    # Every HTD config sets optimizer_config = dict(grad_clip=None)
    # (htd_resnet101_2x.py:120, htd_resnet101_dcn_2x_mstrain.py:119,
    # htd_resnetx101_dcn_2x_mstrain.py:117, _base_/schedules/schedule_1x.py:3)
    # — clipping is available as an explicit opt-in only.
    grad_clip_norm: Optional[float] = None
    # Train-time Resize img_scale. Fixed (1333, 800) for r50_1x/r101_2x;
    # the mstrain configs sample the short side uniformly in a range
    # (img_scale=[(1600, 400), (1600, 1400)] with keep_ratio=True).
    img_scale: Tuple[int, int] = (1333, 800)
    mstrain_range: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None


@dataclass(frozen=True)
class HTDConfig:
    backbone: BackboneConfig = BackboneConfig()
    fpn: FPNConfig = FPNConfig()
    rpn: RPNConfig = RPNConfig()
    proposal_test: ProposalConfig = ProposalConfig()
    roi_extractor: RoIExtractorConfig = RoIExtractorConfig()
    stage0_head: BBoxHeadConfig = BBoxHeadConfig()
    stage1_head: HTDHeadConfig = HTDHeadConfig()
    global_ctx: GlobalContextConfig = GlobalContextConfig()
    rcnn_test: RCNNTestConfig = RCNNTestConfig()
    train: TrainConfig = TrainConfig()
    with_global: bool = True
    num_classes: int = 80
    # dtype policy: "float32" | "bfloat16" compute for conv/matmul paths
    compute_dtype: str = "float32"
    # Test-pipeline img_scale. (1333, 800) for r50/r101/r101-dcn
    # (htd_resnet101_dcn_2x_mstrain.py:27); (1600, 800) for x101-dcn
    # (htd_resnetx101_dcn_2x_mstrain.py:27).
    test_scale: Tuple[int, int] = (1333, 800)

    def replace(self, **kw) -> "HTDConfig":
        return dataclasses.replace(self, **kw)


def htd_r50_1x(**overrides) -> HTDConfig:
    """configs/htd/htd_resnet50_1x.py."""
    return HTDConfig(**overrides)


def htd_r101_2x(**overrides) -> HTDConfig:
    """configs/htd/htd_resnet101_2x.py (soft-NMS test cfg, 2x schedule)."""
    cfg = HTDConfig(
        backbone=BackboneConfig(depth=101),
        rcnn_test=RCNNTestConfig(use_soft_nms=True),
        train=dataclasses.replace(
            TrainConfig(), lr_steps=(16, 22), total_epochs=24
        ),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def htd_r101_dcn_2x(**overrides) -> HTDConfig:
    """configs/htd/htd_resnet101_dcn_2x_mstrain.py — the 50.4 AP flagship."""
    cfg = HTDConfig(
        backbone=BackboneConfig(
            depth=101, stage_with_dcn=(False, True, True, True)
        ),
        rcnn_test=RCNNTestConfig(use_soft_nms=True),
        train=dataclasses.replace(
            TrainConfig(), lr_steps=(16, 22), total_epochs=24,
            mstrain_range=((1600, 400), (1600, 1400)),
        ),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def htd_x101_dcn_2x(**overrides) -> HTDConfig:
    """configs/htd/htd_resnetx101_dcn_2x_mstrain.py (ResNeXt-101 64x4d)."""
    cfg = HTDConfig(
        backbone=BackboneConfig(
            depth=101,
            groups=64,
            base_width=4,
            stage_with_dcn=(False, True, True, True),
        ),
        rcnn_test=RCNNTestConfig(use_soft_nms=True),
        train=dataclasses.replace(
            TrainConfig(), lr_steps=(16, 22), total_epochs=24,
            mstrain_range=((1600, 400), (1600, 1400)),
        ),
        test_scale=(1600, 800),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def htd_detectors_r50_1x(**overrides) -> HTDConfig:
    """HTD R-50 1x (configs/htd/htd_resnet50_1x.py: heads, RPN, hard NMS,
    test scale 1333x800) under DetectoRS's ResNet-50 and RFP neck, as
    mmdetection v2.7.0's configs/detectors/detectors_cascade_rcnn_r50_1x_coco.py
    sets them: ConvAWS everywhere, deformable SAC in layer2-4 of both
    backbones, rfp_steps 2 (ASPP's widths and dilations are `fpn.ASPP`'s)."""
    cfg = HTDConfig(
        backbone=BackboneConfig(conv_aws=True, stage_with_sac=(False, True, True, True)),
        fpn=FPNConfig(rfp_steps=2),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# CLI override + dump (the reference's --cfg-options DictAction + config
# dump into work_dir, tools/train.py:55-60,124)
# ---------------------------------------------------------------------------


def _coerce(old, s: str):
    """Parse `s` to the type of the existing field value `old`."""
    if isinstance(old, bool):
        return s.lower() in ("1", "true", "yes")
    if isinstance(old, tuple) or (old is None and "," in s):
        items = [x for x in s.split(",") if x != ""]
        elem = old[0] if isinstance(old, tuple) and len(old) else 0.0
        if isinstance(elem, tuple):  # nested tuple e.g. mstrain_range
            raise ValueError("nested tuple overrides unsupported; "
                             "use a preset or python API")
        cast = int if isinstance(elem, int) and not isinstance(elem, bool) else float
        return tuple(cast(x) for x in items)
    if old is None:
        for cast in (int, float):
            try:
                return cast(s)
            except ValueError:
                pass
        return None if s.lower() == "none" else s
    if isinstance(old, int) and not isinstance(old, bool):
        return int(s)
    if isinstance(old, float):
        return float(s) if s.lower() != "none" else None
    return s


def _child(node, key: str):
    return node[int(key)] if isinstance(node, tuple) else getattr(node, key)


def _with_child(node, key: str, value):
    if isinstance(node, tuple):
        i = int(key)
        return node[:i] + (value,) + node[i + 1:]
    return dataclasses.replace(node, **{key: value})


def apply_overrides(cfg: HTDConfig, options: "list[str]") -> HTDConfig:
    """Apply 'dotted.path=value' overrides to a (frozen, nested) config; a
    number in the path indexes a tuple of configs (`train.rcnn.0`).

    Example: apply_overrides(cfg, ["train.lr=0.01", "compute_dtype=bfloat16",
    "train.lr_steps=16,22", "rcnn_test.use_soft_nms=true",
    "train.rcnn.1.sampler.num=256"]).
    """
    for opt in options:
        path, _, raw = opt.partition("=")
        keys = path.strip().split(".")
        # walk down collecting the dataclass chain
        chain = [cfg]
        for k in keys[:-1]:
            chain.append(_child(chain[-1], k))
        new = _coerce(_child(chain[-1], keys[-1]), raw.strip())
        node = _with_child(chain[-1], keys[-1], new)
        for parent, k in zip(reversed(chain[:-1]), reversed(keys[:-1])):
            node = _with_child(parent, k, node)
        cfg = node
    return cfg


def dump_config(cfg: HTDConfig) -> str:
    """Resolved config as pretty json (archived in work_dir like the
    reference's cfg.dump)."""
    import json

    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
