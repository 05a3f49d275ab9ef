"""Shared pieces for the port's parity tests (tests/test_torch_*.py).

The JAX package and the port (`htd_tpu_torch`) get the same weights: a
JAX `init` of the detector on the tiny config, handed to the port through
`state_dict_from_flax`. Inputs are made with numpy from a seed and given to
both. JAX runs on the CPU at highest matmul precision (tests/conftest.py).
"""

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from htd_tpu.models.detector import HTDDetector as JaxDetector
from htd_tpu_torch import config as PC
from htd_tpu_torch.models.detector import HTDDetector as PortDetector
from htd_tpu_torch.weights import state_dict_from_flax
from tests.tiny import tiny_config


def port_config(cfg):
    """The JAX package's config as the port's dataclasses (same fields)."""
    if isinstance(cfg, tuple):
        return tuple(port_config(v) for v in cfg)
    if not dataclasses.is_dataclass(cfg):
        return cfg
    cls = getattr(PC, type(cfg).__name__)
    return cls(**{f.name: port_config(getattr(cfg, f.name))
                  for f in dataclasses.fields(cfg)})


def _fill(path, shape, rng):
    """Seeded value for one leaf of the JAX variable tree."""
    name = path[-1]
    if name == "mean":
        return rng.normal(0, 0.1, shape)
    if name == "var":
        return rng.uniform(0.7, 1.4, shape)
    if name == "scale":
        return rng.normal(1.0, 0.1, shape)
    if name in ("bias", "fc_cls_bias", "graph_bias"):
        return rng.normal(0, 0.02, shape)
    fan_in = int(np.prod(shape[-2:-1] if name == "graph_kernel" else shape[:-1]))
    return rng.normal(0, 1.0 / np.sqrt(fan_in), shape)


@functools.lru_cache(maxsize=None)
def _tiny_variables(seed):
    """The JAX detector's variable tree on the tiny config (structure from
    its own `init`, traced only), filled from a numpy seed: drawing ~40M
    values with JAX's CPU generator would dominate the test time."""
    def touch_all(m, images, shapes, rois, valid):
        # every module, without tracing the NMS loops
        return m.rpn_head(m.extract_feats(images)), m.stages_forward(images, shapes, rois, valid)

    model = JaxDetector(tiny_config())
    shapes = jax.eval_shape(lambda r: model.init(
        {"params": r}, jnp.zeros((1, 64, 96, 3)), jnp.asarray([[64.0, 96.0]]),
        jnp.zeros((1, 4, 4)), jnp.ones((1, 4), bool), method=touch_all),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill([k.key for k in p], s.shape, rng).astype(np.float32), shapes)


def tiny_pair(seed=0, **overrides):
    """(jax cfg, jax model, numpy variables, port model) for the tiny
    config at float32; the port runs on the CPU."""
    cfg = tiny_config(**overrides)
    variables = jax.tree_util.tree_map(np.array, _tiny_variables(seed))
    port = PortDetector(port_config(cfg))
    port.load_state_dict(state_dict_from_flax(variables, port.cfg))
    return cfg, JaxDetector(cfg), variables, port.eval()


def t(a):
    """numpy -> torch (CPU)."""
    return torch.from_numpy(np.ascontiguousarray(a))
