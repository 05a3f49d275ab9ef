"""The DCN training slice: the training forward of a detector with
deformable convs in stages 2-4, its loss terms and every parameter's
gradient (the DCN weights and offset convs included) against the JAX
package on the tiny config (float32, CPU), and `create_train_state` /
`train_step` on the DCN presets. The tiny DCN detector's offset convs are
seeded like any conv (`tiny_pair`), so its samples leave their taps and
d_offsets is exercised; at depth 10 every deformable conv has stride 2,
so stride 1 is covered by tests/test_torch_dcn_bwd.py and on the card."""

import numpy as np
import pytest
import torch

from htd_tpu import config as JC
from htd_tpu_torch import config as PC
from htd_tpu_torch.ops.dcn import DeformConv2d
from htd_tpu_torch.train.optim import frozen_prefixes
from htd_tpu_torch.train.train_step import TrainBatch, create_train_state, train_step
from tests.test_torch_train import (B, H, IMG_SHAPES, W, _gts, gradient_failures,
                                    loss_term_failures, run_forward_train)
from tests.tiny import tiny_config
from tests.torch_port import port_config, t

torch.set_num_threads(1)
DCN = (False, True, True, True)
DCN_LEAVES = ("conv2.weight", "conv2.conv_offset.weight", "conv2.conv_offset.bias")


@pytest.fixture(scope="module")
def trained_dcn():
    return run_forward_train(seed=3, backbone=JC.BackboneConfig(depth=10, stage_with_dcn=DCN))


def test_dcn_forward_train_loss_terms_match(trained_dcn):
    """Every loss term (and both accuracies) within 1e-4 relative, with
    non-zero offset convs in the three deformable convs."""
    _, _, port, j_losses, _, p_losses = trained_dcn
    dcn = [m for m in port.modules() if isinstance(m, DeformConv2d)]
    assert len(dcn) == 3 and all(m.conv_offset.weight.abs().max() > 0 for m in dcn)
    failures = loss_term_failures(port, j_losses, p_losses)
    assert not failures, "; ".join(failures)


def test_dcn_forward_train_gradients_match(trained_dcn):
    """The gradient of every parameter against `jax.value_and_grad` of the
    JAX `forward_train`, within tests/test_torch_train.py's ladder (backbone
    2e-2, neck 1e-2, heads 5e-3 of the leaf's largest value); each DCN
    weight and offset-conv leaf has a non-zero gradient that the ladder
    compared."""
    _, variables, port, _, j_grads, _ = trained_dcn
    failures = gradient_failures(port, variables, j_grads)
    assert not failures, "; ".join(failures)
    params = dict(port.named_parameters())
    for stage in (2, 3, 4):
        for leaf in DCN_LEAVES:
            assert float(params[f"backbone.layer{stage}.0.{leaf}"].grad.abs().max()) > 0, leaf


@pytest.mark.parametrize("preset", ["htd_r101_dcn_2x", "htd_x101_dcn_2x"])
def test_create_train_state_dcn_presets(preset):
    """`create_train_state` takes the DCN presets at full depth and width:
    the stem and layer1 frozen, and SGD over everything else, the 30
    deformable convs' weights and offset convs (weight and bias) included."""
    state = create_train_state(getattr(PC, preset)(), device="cpu", seed=0)
    frozen = tuple(frozen_prefixes())
    names = {id(p): n for n, p in state.model.named_parameters()}
    in_sgd = {names[id(p)] for grp in state.optimizer.param_groups for p in grp["params"]}
    assert in_sgd == {n for n in names.values() if not n.startswith(frozen)}
    dcn = {n for n in in_sgd if n.startswith("backbone.") and n.endswith(DCN_LEAVES)}
    assert len(dcn) == 90 and {n.split(".")[1] for n in dcn} == {"layer2", "layer3", "layer4"}


def test_dcn_train_step_on_cpu(rng):
    """One `train_step` of `htd_r101_dcn_2x` cut to depth 10 (the tiny
    config's sampler sizes) on the CPU in bfloat16 autocast: finite float32
    losses, the deformable convs see bfloat16 activations, the stem and
    layer1 bit-unchanged, and every DCN weight and offset-conv leaf moved
    (mmcv's zero offset convs: the samples sit on their taps, and
    d_offsets is the difference of the neighbouring pixels). Each
    bottleneck's last BN scale is set to 0.1 from its zero init
    (`zero_init_residual`), which would leave the residual branches, the
    deformable convs among them, without a gradient in the first step."""
    base = PC.htd_r101_dcn_2x(compute_dtype="bfloat16")
    cfg = base.replace(backbone=PC.BackboneConfig(depth=10, stage_with_dcn=DCN),
                       train=port_config(tiny_config()).train)
    state = create_train_state(cfg, device="cpu", seed=0)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name.endswith(".bn3.weight"):
                p.fill_(0.1)
    images = rng.normal(0, 1, (B, H, W, 3)).astype(np.float32)
    batch = TrainBatch(t(images), t(IMG_SHAPES), *map(t, _gts(rng, cfg.train.max_gt)))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
             for m in state.model.modules() if isinstance(m, DeformConv2d)]
    metrics = train_step(state, batch, torch.Generator().manual_seed(0))
    for h in hooks:
        h.remove()
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in metrics.values())
    assert seen == [torch.bfloat16] * 3
    after = state.model.state_dict()
    for k in before:
        if k.startswith(tuple(frozen_prefixes())):
            assert torch.equal(before[k], after[k]), k
    for stage in (2, 3, 4):
        for leaf in DCN_LEAVES:
            k = f"backbone.layer{stage}.0.{leaf}"
            assert after[k].dtype == torch.float32 and not torch.equal(before[k], after[k]), k
