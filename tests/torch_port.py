"""Shared pieces for the port's parity tests (tests/test_torch_*.py).

The JAX package and the port (`htd_tpu_torch`) get the same weights: a
JAX `init` of the detector on the tiny config, handed to the port through
`state_dict_from_flax`. Inputs are made with numpy from a seed and given to
both. JAX runs on the CPU at highest matmul precision (tests/conftest.py).
"""

import dataclasses
import functools
import json

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


def on_keys(port, jax_side):
    """`port` (a nested dict of the port's config) cut to the keys of the JAX
    package's `jax_side`, and the keys it holds beyond them, dotted."""
    if not isinstance(port, dict):
        return port, []
    cut, extra = {}, [k for k in port if k not in jax_side]
    for k, v in jax_side.items():
        cut[k], more = on_keys(port[k], v) if k in port else (None, [])
        extra += [f"{k}.{m}" for m in more]
    return cut, extra


# the port's fields that only its DetectoRS preset sets, at their defaults
PORT_ONLY = {"backbone.conv_aws": False, "backbone.stage_with_sac": (False,) * 4,
             "fpn.rfp_steps": 1}


def dump_on_jax_keys(text: str) -> str:
    """A dump of the port's config (`config.dump_config`'s JSON) cut to the
    JAX package's keys, in the same form; the keys it holds beyond them
    must be the DetectoRS fields, `PORT_ONLY`."""
    from htd_tpu import config as JC

    cut, extra = on_keys(json.loads(text), json.loads(JC.dump_config(JC.HTDConfig())))
    assert sorted(extra) == sorted(PORT_ONLY)
    return json.dumps(cut, indent=2)


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
def _tiny_variables(seed, overrides=()):
    """The JAX detector's variable tree on `tiny_config(**dict(overrides))`
    (structure from its own `init`, traced only), filled from a numpy seed:
    drawing ~40M values with JAX's CPU generator would dominate the test
    time. A DCN conv's `conv_offset` is filled like any conv, so its
    offsets come out non-zero (std 0.4-0.7 px on the tiny DCN detector,
    4-15% of them beyond 1 px)."""
    def touch_all(m, images, shapes, rois, valid):
        # every module, without tracing the NMS loops
        return m.rpn_head(m.extract_feats(images)), m.stages_forward(images, shapes, rois, valid)

    model = JaxDetector(tiny_config(**dict(overrides)))
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
    variables = jax.tree_util.tree_map(
        np.array, _tiny_variables(seed, tuple(sorted(overrides.items()))))
    port = PortDetector(port_config(cfg))
    port.load_state_dict(state_dict_from_flax(variables, port.cfg))
    return cfg, JaxDetector(cfg), variables, port.eval()


def t(a):
    """numpy -> torch (CPU)."""
    return torch.from_numpy(np.ascontiguousarray(a))
