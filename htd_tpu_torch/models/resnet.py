"""ResNet / ResNeXt backbone with frozen BatchNorm (torchvision / mmdet
layout), with deformable conv2 in the stages that ask for it.

Counterpart of `htd_tpu/models/resnet.py`: pytorch-style bottleneck
(stride on conv2), plain 7x7/2 stem, C2-C5 outputs. Module names are the
mmdet state-dict names (`conv1`, `bn1`, `layer{1-4}.{i}.conv{1-3}`,
`downsample.{0,1}`; a DCN conv2 holds `weight` and `conv_offset`). Depth
10 is the test-only variant of the JAX package's `ARCH_BLOCKS`. A
ResNeXt 3x3 conv is `nn.Conv2d(groups=)`: the JAX package's
block-diagonal dense form is a TPU workaround.

DetectoRS's backbone (mmdet `DetectoRS_ResNet`, port only) sets three
more things: every conv weight-standardised (`layers.ConvAWS2d`), conv2 of
the stages in `stage_with_sac` a switchable atrous conv (`SAConv2d`, mmcv
`SAConv2d`), and, in the recursive feature pyramid's further backbones, an
`rfp_conv` on block 0 of layer2-4 through which `rfp_forward` adds the fed
back features before the block's last ReLU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from htd_tpu_torch.models.layers import ConvAWS2d, FrozenBatchNorm2d, conv, max_pool, standardize
from htd_tpu_torch.ops.dcn import DeformConv2d, deform_conv2d

ARCH_BLOCKS = {
    10: (1, 1, 1, 1),  # test-only tiny variant
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class SAConv2d(ConvAWS2d):
    """mmcv `SAConv2d` (mmcv 1.2) with `use_deform`, 3x3 with padding 1, no
    bias: a global context added before and after, and two deformable
    convolutions (DCNv1, `ops.dcn.deform_conv2d`, K3 on CUDA) over one
    weight-standardised kernel, at dilation 1 and at dilation 3 (padding 3,
    the kernel plus `weight_diff`), blended by a switch read from a 5x5
    average of the input (no sigmoid):

        x   = x + pre_context(mean_hw(x))
        a   = avg_pool5x5(reflect_pad2(x))
        s   = switch(a)                                 1x1 C -> 1, stride
        y   = s * dcn_d1(x, offset_s(a), w) + (1 - s) * dcn_d3(x, offset_l(a), w + weight_diff)
        out = y + post_context(mean_hw(y))

    with w = `standardize(weight, weight_gamma, weight_beta)` and the offset
    convs 3x3 C -> 18 at the stride. Both weights, in the layout K3 reads,
    are kept as `ConvAWS2d` keeps its one. Each call runs in an `htd.sac`
    span. The means are taken over the whole input, the bucket's padding
    included."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.switch = nn.Conv2d(cin, 1, 1, stride=stride)
        self.weight_diff = nn.Parameter(torch.zeros_like(self.weight))
        self.pre_context = nn.Conv2d(cin, cin, 1)
        self.post_context = nn.Conv2d(cout, cout, 1)
        self.offset_s = nn.Conv2d(cin, 18, 3, stride=stride, padding=1)
        self.offset_l = nn.Conv2d(cin, 18, 3, stride=stride, padding=1)

    def derive(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dilation-1 and dilation-3 weights, each the (3, 3, Cin, Cout)
        view of (Cout, 3, 3, Cin) memory that K3 reads."""
        w = standardize(self.weight, self.weight_gamma, self.weight_beta)
        return tuple(v.to(self.weight.dtype).contiguous(memory_format=torch.channels_last)
                     .permute(2, 3, 1, 0) for v in (w, w + self.weight_diff.float()))

    def _deform(self, x, offset_conv, a, weight, dilation):
        off = offset_conv(a).to(x.dtype).permute(0, 2, 3, 1).contiguous()
        out = deform_conv2d(x.permute(0, 2, 3, 1).contiguous(), off, weight.to(x.dtype),
                            self.stride[0], dilation)
        return out.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("htd.sac"):
            x = x + self.pre_context(x.mean((2, 3), keepdim=True))
            a = F.avg_pool2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), 5, 1)
            switch = self.switch(a)
            w_s, w_l = self.weights()
            out_s = self._deform(x, self.offset_s, a, w_s, 1)
            out_l = self._deform(x, self.offset_l, a, w_l, 3)
            out = torch.lerp(out_l, out_s, switch)          # switch * out_s + (1 - switch) * out_l
            return out + self.post_context(out.mean((2, 3), keepdim=True))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 groups: int = 1, base_width: int = 4, with_dcn: bool = False,
                 deform_groups: int = 1, aws: bool = False, sac: bool = False,
                 rfp_inplanes: int = 0):
        """`aws`: every conv a `ConvAWS2d`; `sac`: conv2 a `SAConv2d`;
        `rfp_inplanes`: the channels of the fed back features `rfp_conv`
        adds (0: none)."""
        super().__init__()
        cout = planes * self.expansion
        width = planes if groups == 1 else planes * base_width * groups // 64
        self.conv1 = conv(cin, width, 1, bias=False, aws=aws)
        self.bn1 = FrozenBatchNorm2d(width)
        if sac:
            self.conv2 = SAConv2d(width, width, stride)
        elif with_dcn:
            self.conv2 = DeformConv2d(width, width, stride, groups, deform_groups)
        else:
            self.conv2 = (ConvAWS2d if aws else nn.Conv2d)(
                width, width, 3, stride=stride, padding=1, groups=groups, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = conv(width, cout, 1, bias=False, aws=aws)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(conv(cin, cout, 1, stride=stride, bias=False, aws=aws),
                                            FrozenBatchNorm2d(cout))
        self.rfp_conv = nn.Conv2d(rfp_inplanes, cout, 1) if rfp_inplanes else None

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return out + (x if self.downsample is None else self.downsample(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self._residual(x))

    def rfp_forward(self, x: torch.Tensor, rfp_feat: Optional[torch.Tensor]) -> torch.Tensor:
        """mmdet DetectoRS `Bottleneck.rfp_forward`: `rfp_conv(rfp_feat)`
        added before the last ReLU where the block has an `rfp_conv`."""
        out = self._residual(x)
        if self.rfp_conv is not None:
            out = out + self.rfp_conv(rfp_feat)
        return F.relu(out)


class ResNet(nn.Module):
    """ResNet-50/101/152 (depth 10 for tests), ResNeXt when groups > 1.
    Returns C2-C5 (NCHW)."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (0, 1, 2, 3),
                 base_planes: int = 64,
                 stage_with_dcn: Sequence[bool] = (False, False, False, False),
                 groups: int = 1, base_width: int = 4, deform_groups: int = 1,
                 aws: bool = False,
                 stage_with_sac: Sequence[bool] = (False, False, False, False),
                 rfp_inplanes: int = 0):
        """DetectoRS: `aws` weight-standardises every conv, the stages in
        `stage_with_sac` take a `SAConv2d` conv2, and `rfp_inplanes` gives
        block 0 of layer2-4 an `rfp_conv` (a further backbone of the
        recursive feature pyramid)."""
        super().__init__()
        blocks = ARCH_BLOCKS[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = conv(3, base_planes, 7, stride=2, bias=False, aws=aws)
        self.bn1 = FrozenBatchNorm2d(base_planes)
        cin, planes = base_planes, base_planes
        for stage, n in enumerate(blocks):
            layers = []
            for i in range(n):
                stride = (1 if stage == 0 else 2) if i == 0 else 1
                layers.append(Bottleneck(cin, planes, stride, downsample=(i == 0),
                                         groups=groups, base_width=base_width,
                                         with_dcn=stage_with_dcn[stage],
                                         deform_groups=deform_groups, aws=aws,
                                         sac=stage_with_sac[stage],
                                         rfp_inplanes=rfp_inplanes if stage and not i else 0))
                cin = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
            planes *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)

    def rfp_forward(self, x: torch.Tensor,
                    rfp_feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """mmdet `DetectoRS_ResNet.rfp_forward`: the forward with
        `rfp_feats[i - 1]` fed to every block of stage i (i = 1, 2, 3; only
        block 0 has an `rfp_conv` that reads it)."""
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for stage in range(4):
            feat = rfp_feats[stage - 1] if stage else None
            for block in getattr(self, f"layer{stage + 1}"):
                x = block.rfp_forward(x, feat)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
