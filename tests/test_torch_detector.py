"""The slice as a whole: the port's HTD detector against the JAX package's
on the tiny config at 64x96 (float32, CPU), the weights round trip, and
the entry points with an mmdet checkpoint."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from htd_tpu.train.checkpoint import convert_mmdet_state_dict
from htd_tpu_torch.apis import inference_detector, init_detector
from htd_tpu_torch.models.detector import HTDDetector
from htd_tpu_torch.weights import state_dict_from_flax
from tests import torch_htd as TH
from tests.test_e2e_parity import _assert_rows_match_or_tie, _proposals
from tests.torch_port import port_config, t, tiny_pair
from tests.tiny import tiny_config

torch.set_num_threads(1)
IMG_SHAPE = (60.0, 90.0)
SCALE_FACTOR = (1.1, 1.2, 1.1, 1.2)


@pytest.fixture(scope="module")
def pair():
    cfg, jm, variables, port = tiny_pair(seed=5)
    img = np.random.RandomState(6).normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
    return cfg, jm, variables, port, img


def test_stages_forward_matches(pair):
    """Both cascade stages on fixed proposals (kept away from the level
    boundaries): pre-NMS boxes <= 1e-2 px, softmax scores <= 1e-3."""
    cfg, jm, variables, port, img = pair
    props = _proposals(seed=7, n=24, h=IMG_SHAPE[0], w=IMG_SHAPE[1])
    shapes = np.array([IMG_SHAPE], np.float32)
    valid = np.ones((1, len(props)), bool)
    valid[0, -4:] = False
    jb, js = jax.jit(lambda v, *a: jm.apply(v, *a, method=jm.stages_forward))(
        variables, jnp.asarray(img), jnp.asarray(shapes), jnp.asarray(props[None]),
        jnp.asarray(valid))
    with torch.no_grad():
        pb, ps = port.stages_forward(t(img), t(shapes), t(props[None]), t(valid))
    assert np.abs(pb.numpy() - np.asarray(jb)).max() <= 1e-2
    assert np.abs(ps.numpy() - np.asarray(js)).max() <= 1e-3


def test_simple_test_matches(pair):
    """The whole path (RPN, NMS, both stages, multiclass NMS): the same
    valid detections, boxes <= 1e-2 px and scores <= 1e-3 after matching
    rows (score ties may reorder)."""
    cfg, jm, variables, port, img = pair
    shapes = np.array([IMG_SHAPE], np.float32)
    sf = np.array([SCALE_FACTOR], np.float32)
    jd = jax.jit(jm.apply)(variables, jnp.asarray(img), jnp.asarray(shapes), jnp.asarray(sf))
    with torch.no_grad():
        pd = port.simple_test(t(img), t(shapes), t(sf))
    assert pd.boxes.shape == (1, cfg.rcnn_test.max_per_img, 4)
    assert pd.labels.dtype == torch.int32
    jv, pv = np.asarray(jd.valid[0]), pd.valid[0].numpy()
    assert jv.sum() == pv.sum() > 0
    _assert_rows_match_or_tie(
        np.asarray(jd.boxes[0])[jv], np.asarray(jd.scores[0])[jv],
        pd.boxes[0].numpy()[pv], pd.scores[0].numpy()[pv],
        np.asarray(jd.labels[0])[jv], pd.labels[0].numpy()[pv], box_tol=1e-2)


@pytest.fixture(scope="module")
def mmdet_dict():
    return TH.state_dict_np(TH.randomize(TH.TorchHTDDetector(depth=10), seed=4))


def test_weights_round_trip(mmdet_dict):
    """mmdet dict -> convert_mmdet_state_dict -> state_dict_from_flax gives
    the original dict back, key for key and bit for bit; the port loads
    the original dict with strict key checking."""
    cfg = tiny_config()
    variables = jax.tree_util.tree_map(np.asarray, convert_mmdet_state_dict(mmdet_dict, cfg))
    back = state_dict_from_flax(variables, port_config(cfg))
    want = {k: v for k, v in mmdet_dict.items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    model = HTDDetector(port_config(cfg))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in mmdet_dict.items()})
    assert set(model.state_dict()) == set(want)


def test_entry_points_on_cpu(mmdet_dict, tmp_path, rng):
    """init_detector loads an mmdet .pth; inference_detector returns
    finite (k, 4) boxes in the original image's frame."""
    path = tmp_path / "htd.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in mmdet_dict.items()}}, path)
    cfg = port_config(tiny_config())
    model = init_detector(cfg, checkpoint=str(path), device="cpu")
    np.testing.assert_array_equal(model.state_dict()["rpn_head.rpn_cls.weight"].numpy(),
                                  mmdet_dict["rpn_head.rpn_cls.weight"])
    img = rng.randint(0, 256, (48, 72, 3)).astype(np.uint8)
    boxes, scores, labels = inference_detector(model, img, scale=(96, 64))
    assert boxes.shape == (len(scores), 4) and labels.shape == scores.shape
    assert len(scores) > 0 and np.isfinite(boxes).all()
    assert boxes[:, 2].max() <= 72 + 1e-3 and boxes[:, 3].max() <= 48 + 1e-3
