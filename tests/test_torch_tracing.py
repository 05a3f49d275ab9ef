"""The port's host spans on the inference path.

`apis.inference_detector` runs `htd.preprocess`, the detector's layer
spans and four `htd.sync.to_host` copies; every call that blocks the host
until the device catches up runs in an `htd.sync.<site>` span of its own.
On the CPU the tests read the span tree of one request under
`torch.profiler`; on the card (marked `cuda`, skipped elsewhere) they hold
every runtime synchronisation of R-50, R-101-DCN, X-101-64x4d-DCN and
DetectoRS R-50 requests to those spans:

    python -m pytest --noconftest -s tests/test_torch_tracing.py -k card

This file imports neither JAX nor the JAX package.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from htd_tpu_torch import config as C
from htd_tpu_torch.apis import aug_inference_detector, inference_detector, init_detector

LAYERS = ("htd.backbone_fpn", "htd.rpn_proposals", "htd.pyramid", "htd.global",
          "htd.stage0", "htd.stage1", "htd.post")
REQUEST = "test.request"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")


def tiny(soft: bool = False) -> C.HTDConfig:
    return C.HTDConfig(backbone=C.BackboneConfig(depth=10),
                       proposal_test=C.ProposalConfig(nms_pre=64, nms_post=48, max_num=48),
                       rcnn_test=C.RCNNTestConfig(max_per_img=10, use_soft_nms=soft))


def image(seed: int, h: int = 60, w: int = 90) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def host_events(prof):
    """(name, start, end) in ns of every host event, by start (outer first
    where two start together)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() != cuda]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def inside(s, t) -> bool:
    return s is not t and t[1] <= s[1] and s[2] <= t[2]


def spans_of(prof):
    return [s for s in host_events(prof) if s[0].startswith("htd.")]


def top_level(spans):
    return [s for s in spans if not any(inside(s, t) for t in spans)]


def named(spans, prefix):
    return [s for s in spans if s[0] == prefix or s[0].startswith(prefix + ".")]


@pytest.fixture
def equal_calls(monkeypatch):
    """Counts the `torch.equal` calls (ops/nms.nms's convergence checks)."""
    calls = []
    real = torch.equal

    def spy(a, b):
        calls.append(1)
        return real(a, b)

    monkeypatch.setattr(torch, "equal", spy)
    return calls


def check_nms_spans(spans, equal_calls):
    nms = named(spans, "htd.sync.nms")
    holders = [t for t in spans if t[0] in ("htd.rpn_proposals", "htd.post")]
    assert all(any(inside(s, t) for t in holders) for s in nms)
    assert len(nms) == len(equal_calls) > 0
    return nms


def test_request_span_tree(equal_calls):
    model = init_detector(tiny(), device="cpu", seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inference_detector(model, image(1), scale=(96, 64))
    spans = spans_of(prof)
    top = [s[0] for s in top_level(spans)]
    assert top == ["htd.preprocess", *LAYERS] + ["htd.sync.to_host"] * 4
    pre = named(spans, "htd.preprocess")[0]
    uploads = named(spans, "htd.sync.upload")
    # the image, the resize's two axes of four tables, scale factor, mean,
    # std, image shape
    assert len(uploads) == 1 + 8 + 4 and all(inside(s, pre) for s in uploads)
    nms = check_nms_spans(spans, equal_calls)
    post = named(spans, "htd.post")[0]
    assert any(inside(s, post) for s in nms)
    rpn = named(spans, "htd.rpn_proposals")[0]
    assert any(inside(s, rpn) for s in nms)
    # every sync but the copies to the host lies in preprocess or a layer
    layers = [t for t in spans if t[0] in LAYERS or t is pre]
    for s in named(spans, "htd.sync"):
        assert (s[0] == "htd.sync.to_host") != any(inside(s, t) for t in layers), s[0]


def test_soft_nms_post_has_no_nms_sync(equal_calls):
    """On a request after the first, post holds no sync at all: soft-NMS's
    rounds stay on the device, and the box decode's coder constants were
    made on the device at their first use and kept (ops/boxes); the
    hard-NMS checks (the CPU's fixpoint) all lie in the RPN."""
    model = init_detector(tiny(soft=True), device="cpu", seed=0)
    inference_detector(model, image(2, 90, 60), scale=(96, 64))
    equal_calls.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inference_detector(model, image(2, 90, 60), scale=(96, 64))
    spans = spans_of(prof)
    post = named(spans, "htd.post")[0]
    in_post = [s[0] for s in named(spans, "htd.sync") if inside(s, post)]
    assert in_post == []
    assert not named(spans, "htd.sync.box_coder")
    rpn = named(spans, "htd.rpn_proposals")[0]
    assert all(inside(s, rpn) for s in check_nms_spans(spans, equal_calls))


def test_tta_carries_the_same_spans(equal_calls):
    model = init_detector(tiny(), device="cpu", seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        aug_inference_detector(model, image(3), scales=((96, 64), (128, 96)), flip=True)
    spans = spans_of(prof)
    top = [s[0] for s in top_level(spans)]
    assert top[0] == "htd.preprocess" and top[-4:] == ["htd.sync.to_host"] * 4
    assert "htd.sync.to_host" not in top[:-4]
    pre = named(spans, "htd.preprocess")[0]
    uploads = named(spans, "htd.sync.upload")
    assert len(uploads) == 4 * 13 and all(inside(s, pre) for s in uploads)
    check_nms_spans(spans, equal_calls)
    # four proposal passes and the merge; four cascade passes; one post
    assert Counter(top)["htd.rpn_proposals"] == 5
    assert Counter(top)["htd.backbone_fpn"] == 8 and Counter(top)["htd.post"] == 1


@pytest.mark.parametrize("groups", [1, 64], ids=["r101dcn", "x101dcn"])
def test_each_deformable_conv_is_one_dcn_span(monkeypatch, groups):
    """Each `DeformConv2d` call of a request (R-101-DCN's one weight group
    and X-101-64x4d-DCN's 64, at depth 10) runs its offset conv and its K3
    call inside one `htd.dcn` span of its own, nested in
    `htd.backbone_fpn`; the top-level spans are those of every request."""
    from htd_tpu_torch.ops import dcn

    cfg = tiny().replace(backbone=C.BackboneConfig(
        depth=10, groups=groups, base_width=4, stage_with_dcn=(False, True, True, True)),
        rcnn_test=C.RCNNTestConfig(max_per_img=10, use_soft_nms=True))
    model = init_detector(cfg, device="cpu", seed=0)
    convs = [m for m in model.modules() if isinstance(m, dcn.DeformConv2d)]
    assert len(convs) == 3 and all(m.groups == groups for m in convs)
    real_k3 = dcn.deform_conv2d

    def k3(*args, **kw):
        with record_function("test.k3"):
            return real_k3(*args, **kw)

    monkeypatch.setattr(dcn, "deform_conv2d", k3)
    for m in convs:
        def offset(x, real=m.conv_offset.forward):
            with record_function("test.offset"):
                return real(x)

        monkeypatch.setattr(m.conv_offset, "forward", offset)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inference_detector(model, image(6), scale=(96, 64))
    events = host_events(prof)
    spans = [e for e in events if e[0].startswith("htd.")]
    assert [s[0] for s in top_level(spans)] == \
        ["htd.preprocess", *LAYERS] + ["htd.sync.to_host"] * 4
    dcn_spans = named(spans, "htd.dcn")
    backbone = named(spans, "htd.backbone_fpn")
    assert len(dcn_spans) == len(convs) and len(backbone) == 1
    assert all(inside(s, backbone[0]) for s in dcn_spans)
    for name in ("test.k3", "test.offset"):
        calls = [e for e in events if e[0] == name]
        assert len(calls) == len(convs), name
        assert all(sum(inside(c, s) for s in dcn_spans) == 1 for c in calls), name
        assert all(sum(inside(c, s) for c in calls) == 1 for s in dcn_spans), name


def test_detectors_request_runs_rfp_and_sac_spans(monkeypatch):
    """An eager DetectoRS request (depth 10: three SAC convs a backbone)
    runs the recursive feature pyramid's second step in one `htd.rfp` span
    and each switchable atrous conv in an `htd.sac` span of its own, three
    of them inside `htd.rfp` (the second backbone's), all nested in
    `htd.backbone_fpn`; each SAC span holds its two deformable convs (K3 at
    dilation 1 and 3) and the request's top-level spans are R-50's."""
    from htd_tpu_torch.models import resnet

    cfg = C.htd_detectors_r50_1x().replace(
        backbone=C.BackboneConfig(depth=10, conv_aws=True,
                                  stage_with_sac=(False, True, True, True)),
        proposal_test=C.ProposalConfig(nms_pre=64, nms_post=48, max_num=48),
        rcnn_test=C.RCNNTestConfig(max_per_img=10))
    model = init_detector(cfg, device="cpu", seed=0)
    real_k3 = resnet.deform_conv2d

    def k3(x, off, w, stride, dilation):
        with record_function(f"test.k3.d{dilation}"):
            return real_k3(x, off, w, stride, dilation)

    monkeypatch.setattr(resnet, "deform_conv2d", k3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inference_detector(model, image(7), scale=(96, 64))
    events = host_events(prof)
    spans = [e for e in events if e[0].startswith("htd.")]
    assert [s[0] for s in top_level(spans)] == \
        ["htd.preprocess", *LAYERS] + ["htd.sync.to_host"] * 4
    backbone = named(spans, "htd.backbone_fpn")
    rfp, sac = named(spans, "htd.rfp"), named(spans, "htd.sac")
    assert len(backbone) == 1 and len(rfp) == 1 and len(sac) == 6
    assert all(inside(s, backbone[0]) for s in rfp + sac)
    assert sum(inside(s, rfp[0]) for s in sac) == 3
    for d in (1, 3):
        calls = [e for e in events if e[0] == f"test.k3.d{d}"]
        assert len(calls) == 6 and all(sum(inside(c, s) for s in sac) == 1 for c in calls)


def test_training_forward_carries_the_dcn_spans():
    """A train step of the tiny R-101-DCN model on the CPU: its forward runs
    each of the 3 deformable convs in an `htd.dcn` span inside the step's
    one `htd.backbone_fpn`."""
    from htd_tpu_torch.train.train_step import TrainBatch, create_train_state, train_step

    cfg = tiny().replace(backbone=C.BackboneConfig(
        depth=10, stage_with_dcn=(False, True, True, True)))
    state = create_train_state(cfg, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    boxes = np.zeros((1, 8, 4), np.float32)
    boxes[0, :2] = [[4, 6, 40, 50], [30, 10, 90, 60]]
    valid = np.zeros((1, 8), bool)
    valid[0, :2] = True
    batch = TrainBatch(torch.from_numpy(rng.normal(0, 1, (1, 64, 96, 3)).astype(np.float32)),
                       torch.tensor([[64.0, 96.0]]), torch.from_numpy(boxes),
                       torch.from_numpy(rng.randint(0, 80, (1, 8)).astype(np.int32)),
                       torch.from_numpy(valid))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch, torch.Generator().manual_seed(0))
    spans = spans_of(prof)
    backbone = named(spans, "htd.backbone_fpn")
    dcn_spans = named(spans, "htd.dcn")
    assert len(backbone) == 1 and len(dcn_spans) == 3
    assert all(inside(s, backbone[0]) for s in dcn_spans)


# -- on the card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def is_sync(name: str) -> bool:
    """A runtime call that blocks the host until the device has caught up."""
    return name in SYNC_CALLS or (name.startswith(("cudaMemcpy", "cuMemcpy"))
                                  and "Async" not in name)


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["htd_r50_1x", "htd_r101_dcn_2x", "htd_x101_dcn_2x",
                                    "htd_detectors_r50_1x"])
def test_every_sync_on_the_card_is_in_a_sync_span(cuda, preset):
    """Two requests that capture the front's graphs (backbone, FPN, RPN
    and proposals; one per bucket), then two that replay them: every
    runtime synchronisation lies in an `htd.sync.*` span, one to a span,
    and a request has 13 `upload` and 4 `to_host` ones and no others: the
    box coder's constants stay on the device and hard NMS is one kernel
    call, so neither `box_coder` nor `nms` syncs (in the RPN, the heads or
    post); each capture's own lies in the one `htd.sync.capture` span of
    its capturing request, inside its `htd.graph.capture` span. A capturing DetectoRS request runs
    its backbones' Python (the eager warm-up, and the capture), which opens
    an `htd.rfp` span and 26 `htd.sac` spans each time inside
    `htd.backbone_fpn`; a replayed one opens none."""
    model = init_detector(getattr(C, preset)(compute_dtype="bfloat16"), seed=0)
    imgs = [image(4, 480, 640), image(5, 640, 480)]
    for img in imgs:                    # builds the kernels, caches the anchors and constants
        inference_detector(model, img)
    torch.cuda.synchronize()
    model._drop_graphs()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for img in imgs + imgs:
            with record_function(REQUEST):
                inference_detector(model, img)
    events = host_events(prof)
    requests = [e for e in events if e[0] == REQUEST]
    spans = [e for e in events if e[0].startswith("htd.")]
    syncs = [e for e in events if is_sync(e[0]) and any(inside(e, r) for r in requests)]
    sync_spans = named(spans, "htd.sync")
    outside = [(e[0], next((t[0] for t in reversed(spans) if inside(e, t)), "entry"))
               for e in syncs if not any(inside(e, s) for s in sync_spans)]
    per_span = Counter(sum(1 for e in syncs if inside(e, s)) for s in sync_spans)
    per_kind = {}
    for kind, reqs in (("capturing", requests[:2]), ("replayed", requests[2:])):
        mine = [s for s in sync_spans if any(inside(s, r) for r in reqs)]
        n = sum(1 for e in syncs if any(inside(e, r) for r in reqs))
        sites = per_kind[kind] = Counter(s[0] for s in mine)
        print(f"\n{preset}, {kind} requests: {n / 2} runtime synchronisations per request, "
              f"{len(mine) / 2} htd.sync.* spans per request; per site: "
              + ", ".join(f"{k} {v / 2}" for k, v in sorted(sites.items()))
              + f"; {torch.cuda.get_device_name(0)}")
    assert len(requests) == 4
    assert not outside, f"synchronisations outside every htd.sync.* span: {outside}"
    assert per_span == Counter({1: len(sync_spans)}), f"syncs per span: {per_span}"
    captures = named(spans, "htd.graph.capture")
    held = named(spans, "htd.sync.capture")
    assert len(captures) == len(held) == 2
    assert all(inside(s, c) and inside(c, r) for s, c, r in zip(held, captures, requests))
    replayed = Counter({"htd.sync.upload": 2 * 13, "htd.sync.to_host": 2 * 4})
    assert per_kind["replayed"] == replayed
    assert per_kind["capturing"] == replayed + Counter({"htd.sync.capture": 2})
    rfp, sac = named(spans, "htd.rfp"), named(spans, "htd.sac")
    if preset == "htd_detectors_r50_1x":
        backbones = named(spans, "htd.backbone_fpn")
        first = [s for s in rfp if any(inside(s, r) for r in requests[:2])]
        assert len(first) >= 2 and len(rfp) == len(first)
        assert len(sac) == 26 * len(first)        # the warm-up's (and the capture's) calls
        assert all(any(inside(s, b) for b in backbones) for s in rfp + sac)
    else:
        assert not rfp and not sac
