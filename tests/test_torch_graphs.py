"""The backbone, FPN, RPN head and proposals replayed as CUDA graphs
(`models/graphs.py`).

On the CPU: which calls stay eager (and capture nothing), what tells two
graphs apart, what drops them, and what a capture and a replay run and
count, with the CUDA parts stood in for. On the card (marked `cuda`, skipped elsewhere): R-50,
R-101-DCN (K3 on the tensor cores), X-101-64x4d-DCN (grouped K3) and
DetectoRS R-50 as the benchmark builds them, whose replayed levels,
proposals and detections must equal the eager ones bit for bit:

    python -m pytest --noconftest tests/test_torch_graphs.py -q

This file imports neither JAX nor the JAX package.
"""

import contextlib

import numpy as np
import pytest
import torch

from htd_tpu_torch import config as C
from htd_tpu_torch.apis import inference_detector, init_detector
from htd_tpu_torch.models import graphs


def tiny() -> C.HTDConfig:
    return C.HTDConfig(backbone=C.BackboneConfig(depth=10),
                       proposal_test=C.ProposalConfig(nms_pre=64, nms_post=48, max_num=48),
                       rcnn_test=C.RCNNTestConfig(max_per_img=10))


def batch(seed: int, b: int = 1, h: int = 64, w: int = 96, dev="cpu"):
    """(images, img_shapes, scale_factors) of a normalized bucket batch."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)).to(dev)
    shapes = torch.tensor([[h, w]] * b, dtype=torch.float32, device=dev)
    return images, shapes, torch.ones((b, 4))


@pytest.fixture
def counts():
    graphs.reset_graph_counts()
    yield graphs.graph_counts
    graphs.reset_graph_counts()


# -- on the CPU ------------------------------------------------------------------


@contextlib.contextmanager
def state(model, how: str):
    """The call state in which `how` is the first reason to stay eager."""
    if how == "autograd":
        with torch.enable_grad():
            yield
        return
    if how == "training":
        model.train()
    handles = []
    if how == "hook":
        handles.append(model.backbone.layer1[0].conv1.register_forward_hook(
            lambda m, args, out: None))
    if how == "pre_hook":
        handles.append(model.neck.register_forward_pre_hook(lambda m, args: None))
    try:
        with torch.inference_mode():
            yield
    finally:
        for h in handles:
            h.remove()
        model.eval()


@pytest.mark.parametrize("how", ["device", "autograd", "training", "hook", "pre_hook"])
def test_calls_that_cannot_replay_run_eagerly(counts, how):
    """CPU images, autograd on, training mode and a forward hook or
    pre-hook each keep the backbone and FPN eager: each of the three
    inference calls counts one eager run and captures nothing."""
    model = init_detector(tiny(), device="cpu", seed=0)
    images, shapes, sfs = batch(1)
    rois = torch.tensor([[[4.0, 6.0, 40.0, 50.0], [10.0, 8.0, 90.0, 60.0]]])
    with state(model, how):
        want = "hook" if how == "pre_hook" else how
        assert model._eager_reason(images) == want
        model.simple_test(images, shapes, sfs)
        model.rpn_proposals(images, shapes)
        model.stages_forward(images, shapes, rois, torch.ones((1, 2), dtype=torch.bool))
    assert dict(counts) == {"capture": 0, "replay": 0, "eager": 3}
    assert model._graphs == {}


def test_calls_that_keep_the_levels_stay_off_the_graphs(counts):
    """`extract_feats` hands the levels to its caller and `forward_train`
    trains through them: neither goes through the graphs nor counts."""
    model = init_detector(tiny(), device="cpu", seed=0)
    images, shapes, _ = batch(2)
    with torch.inference_mode():
        feats = model.extract_feats(images)
    assert len(feats) == 5 and feats[0].shape[1:3] == (16, 24)
    model.train()
    gt_boxes = torch.tensor([[[4.0, 6.0, 40.0, 50.0], [30.0, 10.0, 90.0, 60.0]]])
    losses = model.forward_train(images, shapes, gt_boxes, torch.tensor([[3, 7]]),
                                 torch.ones((1, 2), dtype=torch.bool),
                                 generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(sum(v for k, v in losses.items() if "loss" in k))
    assert dict(counts) == {"capture": 0, "replay": 0, "eager": 0}


@pytest.mark.parametrize("change", ["bucket", "batch", "dtype", "compute_dtype", "HTD_FPN_FENCE",
                                    "HTD_DCN_FENCE", "HTD_RPN_FENCE", "tf32", "inference_mode"])
def test_the_key_tells_graphs_apart(monkeypatch, change):
    """Each of the bucket's shape, the batch, the input's dtype, the compute
    dtype, each fence switch (the FPN's sums, the deformable convs' inputs,
    the RPN head's levels), cuDNN's TF32 flag and inference mode gives
    another key; the same call gives the same key."""
    for switch in graphs.FENCE_SWITCHES:
        monkeypatch.delenv(switch, raising=False)

    def key(b=1, h=64, w=96, dtype=torch.float32, compute=torch.bfloat16):
        return graphs.graph_key(torch.zeros((b, h, w, 3), dtype=dtype), compute)

    with torch.inference_mode():
        base = key()
        assert key() == base
        if change == "bucket":
            other = key(h=96, w=64)
        elif change == "batch":
            other = key(b=2)
        elif change == "dtype":
            other = key(dtype=torch.bfloat16)
        elif change == "compute_dtype":
            other = key(compute=torch.float32)
        elif change.startswith("HTD_"):
            monkeypatch.setenv(change, "1")
            other = key()
        elif change == "tf32":
            monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                                not torch.backends.cudnn.allow_tf32)
            other = key()
    if change == "inference_mode":
        with torch.no_grad():
            other = key()
    assert other != base


@pytest.mark.parametrize("how", ["to", "half", "load_state_dict", "train", "eval"])
def test_what_drops_the_graphs(how):
    """A graph reads the tensors it was captured with: `.to()` (and the
    casts that go through `_apply`), `load_state_dict` and `train()` /
    `eval()` drop every graph and the list of hooked modules."""
    model = init_detector(tiny(), device="cpu", seed=0)
    with torch.inference_mode():
        model._eager_reason(batch(3)[0])
    assert model._graphed_modules is not None
    model._graphs[("a key",)] = object()
    if how == "to":
        model.to(torch.float32)
    elif how == "half":
        model.half()
    elif how == "load_state_dict":
        model.load_state_dict(model.state_dict())
    else:
        getattr(model, how)()
    assert model._graphs == {} and model._graphed_modules is None


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph`: a replay runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def cpu_graphs(monkeypatch):
    """`graphs.FeatureGraph` on the CPU: the CUDA stream, device and graph
    calls stood in for, and the capture an empty context."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_Capture", lambda g, stream: contextlib.nullcontext())


def test_a_capture_calls_fn_twice_and_a_replay_never(cpu_graphs, counts):
    """A capture runs the function twice on the static inputs (the warm-up,
    then the capture); each replay copies its inputs (images and shapes)
    into the static ones, replays the graph and calls the function never."""
    calls = []

    def fn(x, shapes):
        calls.append((x, shapes))
        return (x * 2, shapes + 1)

    (a, sa, _), b, sb = batch(4), batch(5)[0], torch.tensor([[40.0, 70.0]])
    g = graphs.FeatureGraph(fn, a, sa)
    assert len(calls) == 2 and all(x is g.static_in[0] and s is g.static_in[1]
                                   for x, s in calls)
    assert g.graph.replays == 0
    assert dict(counts) == {"capture": 1, "replay": 0, "eager": 0}
    out = g.replay(b, sb)
    assert out is g.outputs and g.graph.replays == 1
    assert torch.equal(g.static_in[0], b) and torch.equal(g.static_in[1], sb)
    g.replay(a, sa)
    assert torch.equal(g.static_in[0], a) and torch.equal(g.static_in[1], sa)
    assert len(calls) == 2 and g.graph.replays == 2
    assert dict(counts) == {"capture": 1, "replay": 2, "eager": 0}


def test_one_graph_per_key_replayed(cpu_graphs, counts, monkeypatch):
    """With the device check passed, the first call at a key captures and
    replays, later calls at it replay, and another bucket gets a graph of
    its own; the first replay's levels and proposals are the eager ones."""
    model = init_detector(tiny(), device="cpu", seed=0)
    monkeypatch.setattr(model, "_eager_reason", lambda images: None)
    (land, shapes, _), port = batch(6), batch(7, h=96, w=64)
    with torch.inference_mode():
        eager = model._features(land)
        got, props = model._levels(land, shapes)
        assert all(torch.equal(e, g) for e, g in zip(eager, got))
        assert all(torch.equal(e, p) for e, p in zip(model._proposals(eager, shapes), props))
        model._levels(land, shapes)
        model._levels(*port[:2])
        model._levels(land, shapes)
    assert len(model._graphs) == 2
    assert dict(counts) == {"capture": 2, "replay": 4, "eager": 0}


# -- on the card -----------------------------------------------------------------

PRESETS = ["htd_r50_1x", "htd_r101_dcn_2x", "htd_x101_dcn_2x", "htd_detectors_r50_1x"]
SEED = 2**31 + 11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bench_model(request):
    """The preset `request.param` as the benchmark builds it
    (`bench_h100/configs`: seeded weights, offset convs seeded for about
    2 px of offset), bfloat16, and its two test buckets (h, w). Needs the
    card."""
    import json

    from bench_h100 import weights, weights_rfp
    from bench_h100.harness import BENCH, port_config
    from bench_h100.program import build_detector
    from htd_tpu_torch.data.pipeline import bucket_shape

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    doc = json.loads((BENCH / "configs" / f"{request.param}.json").read_text())
    cfg = port_config(doc)
    make_state_dict = (weights_rfp if cfg.fpn.rfp_steps > 1 else weights).make_state_dict
    model = build_detector(cfg, make_state_dict(doc["config"], doc["assumed"], SEED, dev), dev)
    yield model, [bucket_shape(cfg.test_scale, land) for land in (True, False)]
    del model
    torch.cuda.empty_cache()


def eager_levels(model, images):
    """`model.neck(model.backbone(x))` of the images, run directly (the
    recursive feature pyramid's neck also takes x)."""
    x = images.to(model.compute_dtype).permute(0, 3, 1, 2)
    x = x.contiguous(memory_format=torch.channels_last)
    if model.cfg.fpn.rfp_steps > 1:
        return model.neck(model.backbone(x), x)
    return model.neck(model.backbone(x))


def same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("bench_model", PRESETS, indirect=True)
def test_which_card_calls_replay(cuda, bench_model):
    """On the card an inference call on the model's device may replay;
    autocast and autograd keep it eager."""
    model, buckets = bench_model
    images = batch(0, h=buckets[0][0], w=buckets[0][1], dev=cuda)[0]
    with torch.inference_mode():
        assert model._eager_reason(images) is None
        with torch.autocast("cuda", dtype=torch.bfloat16):
            assert model._eager_reason(images) == "autocast"
    assert model._eager_reason(images) == "autograd"


def replayed(model, images, shapes):
    """Clones of a replay's levels and proposals."""
    levels, props = model._levels(images, shapes)
    return [t.clone() for t in levels], [t.clone() for t in props]


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [0, 1], ids=["landscape", "portrait"])
@pytest.mark.parametrize("bench_model", PRESETS, indirect=True)
def test_replayed_levels_are_the_eager_levels(cuda, counts, bench_model, bucket):
    """At each bucket the first call captures and replays, the second
    replays: both give `neck(backbone(x))` and the eager proposals on it
    bit for bit; a second image at the same key, resized to another size
    inside the bucket, gets its own levels and its own proposals (the image
    shapes are an input of the graph, not a constant of it)."""
    model, buckets = bench_model
    h, w = buckets[bucket]
    (one, full, _), two = batch(1, h=h, w=w, dev=cuda), batch(2, h=h, w=w, dev=cuda)[0]
    part = torch.tensor([[h - 150.0, w - 310.0]], device=cuda)
    model._drop_graphs()
    with torch.inference_mode():
        first = replayed(model, one, full)
        again = replayed(model, one, full)
        other = replayed(model, two, part)
        want_one, want_two = eager_levels(model, one), eager_levels(model, two)
        props_one = model._proposals(want_one, full)
        props_two = model._proposals(want_two, part)
    torch.cuda.synchronize()
    assert dict(counts) == {"capture": 1, "replay": 3, "eager": 0}
    assert same(first[0], want_one) and same(again[0], want_one)
    assert same(first[1], props_one) and same(again[1], props_one)
    assert same(other[0], want_two) and not same(other[0], want_one)
    assert same(other[1], props_two) and not same(props_two, props_one)
    boxes, valid = other[1][0], other[1][2]
    assert valid.sum() > 0
    assert boxes[..., 2].max() <= w - 310.0 and boxes[..., 3].max() <= h - 150.0


@pytest.mark.cuda
@pytest.mark.parametrize("bench_model", PRESETS, indirect=True)
def test_alternating_buckets_give_their_own_levels(cuda, counts, bench_model):
    """Buckets A, B, A, B replay two graphs in turns, each with its own
    pool: every call's levels are its own eager levels."""
    model, buckets = bench_model
    imgs = [batch(3 + i, h=h, w=w, dev=cuda)[:2] for i, (h, w) in enumerate(buckets)]
    model._drop_graphs()
    with torch.inference_mode():
        got = [replayed(model, *imgs[i % 2])[0] for i in range(4)]
        want = [eager_levels(model, img) for img, _ in imgs]
    torch.cuda.synchronize()
    assert dict(counts) == {"capture": 2, "replay": 4, "eager": 0}
    assert all(same(g, want[i % 2]) for i, g in enumerate(got))


@pytest.mark.cuda
@pytest.mark.parametrize("bench_model", PRESETS, indirect=True)
def test_detections_as_with_fresh_graphs_and_eager(cuda, counts, bench_model):
    """`inference_detector` on two images in both orientations, twice: the
    replayed requests' detections equal those of requests whose graphs
    were all dropped just before (a capture each) and those of eager
    requests (a forward hook on the neck), bit for bit."""
    model, _ = bench_model
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((480, 640), (640, 480))]
    replayed = [inference_detector(model, imgs[i % 2]) for i in range(4)]
    fresh = []
    for img in imgs:
        model._drop_graphs()
        fresh.append(inference_detector(model, img))
    handle = model.neck.register_forward_hook(lambda m, args, out: None)
    try:
        eager = [inference_detector(model, img) for img in imgs]
    finally:
        handle.remove()
    assert counts["eager"] == 2 and counts["capture"] >= 2
    for i, dets in enumerate(replayed):
        for want in (fresh[i % 2], eager[i % 2]):
            assert all(np.array_equal(a, b) for a, b in zip(dets, want)), i
    assert all(len(d[1]) > 0 for d in replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("bench_model", PRESETS, indirect=True)
def test_a_replayed_request_runs_the_rpn_nms_in_the_graph(cuda, counts, bench_model,
                                                          monkeypatch):
    """A replayed request's trace holds the hard-NMS kernels of the RPN
    (the mask and scan launches, once each), which the host never
    launched: its only call of the hard-NMS launcher is post's, under hard
    NMS (R-50 and DetectoRS R-50; soft-NMS in the DCN presets, one soft-NMS
    kernel instead). A trace that lost a kernel record is taken again."""
    from htd_tpu_torch.apis import inference_detector
    from htd_tpu_torch.ops import nms_cuda
    from htd_tpu_torch.utils.profiling import kernel_counts

    model, _ = bench_model
    img = np.random.default_rng(13).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    inference_detector(model, img)
    torch.cuda.synchronize()
    launched = []
    launch_nms = nms_cuda.launch_nms
    monkeypatch.setattr(nms_cuda, "launch_nms",
                        lambda *args: (launched.append(args[0].shape[0]), launch_nms(*args))[1])
    soft = model.cfg.rcnn_test.use_soft_nms
    want = {"nms_mask_kernel": 2 - soft, "nms_scan_kernel": 2 - soft, "soft_nms_kernel": soft}

    def request():
        graphs.reset_graph_counts()
        launched.clear()
        return inference_detector(model, img)

    (boxes, _, _), got = kernel_counts(request, want)
    assert {k: got.get(k, 0) for k in want} == want
    assert launched == ([] if soft else [2048])
    assert dict(counts) == {"capture": 0, "replay": 1, "eager": 0}
    assert len(boxes) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bench_model", PRESETS, indirect=True)
def test_flip_tta_as_with_eager(cuda, counts, bench_model):
    """`aug_inference_detector` at the test scale with flip, twice with the
    graphs (the first call captures: the flipped image replays the key the
    plain one captured, while the plain one's proposals are still held),
    gives the detections of an eager call (a forward hook on the neck),
    bit for bit."""
    from htd_tpu_torch.apis import aug_inference_detector

    model, _ = bench_model
    img = np.random.default_rng(14).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    model._drop_graphs()
    graphed = [aug_inference_detector(model, img, flip=True) for _ in range(2)]
    assert counts["capture"] == 1 and counts["eager"] == 0 and counts["replay"] == 8
    handle = model.neck.register_forward_hook(lambda m, args, out: None)
    try:
        eager = aug_inference_detector(model, img, flip=True)
    finally:
        handle.remove()
    assert counts["eager"] == 4
    assert len(eager[1]) > 0
    for dets in graphed:
        assert all(np.array_equal(a, b) for a, b in zip(dets, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("bench_model", PRESETS[1:3], indirect=True)
def test_a_replayed_request_runs_the_30_k3_kernels(cuda, counts, bench_model):
    """Under the profiler a replayed DCN request opens one `htd.graph.replay`
    span inside `htd.backbone_fpn` and no `htd.dcn` span, and its trace
    holds the 30 `deform_conv_fwd` kernels the graph launched (a trace that
    lost a kernel record is taken again, 3 at most)."""
    from torch.profiler import ProfilerActivity, profile

    from bench_h100.trace import from_profiler

    model, _ = bench_model
    img = np.random.default_rng(10).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    inference_detector(model, img)
    torch.cuda.synchronize()
    for _ in range(3):
        graphs.reset_graph_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            inference_detector(model, img)
            torch.cuda.synchronize()
        tr = from_profiler(prof)
        k3 = [n for n, *_ in tr.device if "deform_conv_fwd" in n]
        if len(k3) == 30:
            break
    assert len(k3) == 30, f"{len(k3)} K3 kernels in 3 traces"
    assert dict(counts) == {"capture": 0, "replay": 1, "eager": 0}
    names = [n for n, *_ in tr.spans]
    assert "htd.dcn" not in names and names.count("htd.graph.replay") == 1
    backbone = [(a, b) for n, a, b in tr.spans if n == "htd.backbone_fpn"]
    replay = [(a, b) for n, a, b in tr.spans if n == "htd.graph.replay"]
    assert len(backbone) == 1 and backbone[0][0] <= replay[0][0] <= replay[0][1] <= backbone[0][1]


@pytest.mark.cuda
@pytest.mark.parametrize("bench_model", PRESETS[3:], indirect=True)
def test_a_replayed_rfp_request_runs_both_backbones_in_one_graph(cuda, counts, bench_model):
    """A replayed DetectoRS request opens one `htd.graph.replay` span inside
    `htd.backbone_fpn` and no `htd.rfp`, `htd.sac` or `htd.dcn` span: both
    backbones, ASPP and the gate are in the graph, whose trace holds SAC's 52
    `deform_conv_fwd` kernels (26 SAC convs, two each) and the two FPN
    passes' 6 `upsample_add` kernels (a trace that lost a kernel record is
    taken again, 3 at most). Prints the peak memory of a capturing request."""
    from torch.profiler import ProfilerActivity, profile

    from bench_h100.trace import from_profiler

    model, _ = bench_model
    img = np.random.default_rng(12).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    model._drop_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inference_detector(model, img)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for _ in range(3):
        graphs.reset_graph_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            inference_detector(model, img)
            torch.cuda.synchronize()
        tr = from_profiler(prof)
        k3 = [n for n, *_ in tr.device if "deform_conv_fwd" in n]
        k7 = [n for n, *_ in tr.device if "upsample_add" in n]
        if len(k3) == 52 and len(k7) == 6:
            break
    print(f"\nDetectoRS R-50: peak {peak / 2**20:.0f} MiB over a capturing request at 800x1344; "
          f"{torch.cuda.get_device_name(0)}")
    assert (len(k3), len(k7)) == (52, 6), f"{len(k3)} K3 and {len(k7)} K7 kernels in 3 traces"
    assert all("deform_conv_fwd_tc_kernel" in n for n in k3), set(k3)
    assert dict(counts) == {"capture": 0, "replay": 1, "eager": 0}
    names = [n for n, *_ in tr.spans]
    assert not {"htd.dcn", "htd.sac", "htd.rfp"} & set(names)
    assert names.count("htd.graph.replay") == 1
