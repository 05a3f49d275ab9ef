"""Typed configuration for htd_tpu_torch.

A framework-free copy of the JAX package's configuration dataclasses and
presets, kept here so that the port imports nothing of `htd_tpu`. A test
holds every preset's `dataclasses.asdict` equal to the JAX package's, so
the two copies cannot drift. The presets transcribe the HTD configs:
  * htd_r50_1x           <- configs/htd/htd_resnet50_1x.py
  * htd_r101_2x          <- configs/htd/htd_resnet101_2x.py
  * htd_r101_dcn_2x      <- configs/htd/htd_resnet101_dcn_2x_mstrain.py
  * htd_x101_dcn_2x      <- configs/htd/htd_resnetx101_dcn_2x_mstrain.py
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


@dataclass(frozen=True)
class FPNConfig:
    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5                    # P2-P5 + P6 (maxpool of P5)


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
