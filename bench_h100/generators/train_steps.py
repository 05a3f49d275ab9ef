"""Training steps: `htd_tpu_torch.train.train_step` at a fixed batch per
card, on synthetic images with seeded ground truth, fed through the
program's own batch builder (`data.coco.make_train_batch`).

Traffic parameters (the traffic file):
- `batch`: images per step; `pool`, `sizes`, `size_shares`: the images
  (`images.make_pool`);
- `gts`: [least, most] ground-truth boxes per image (`images.make_boxes`);
- `flip_prob`: each image flipped with this probability, drawn per step;
- `scales`: "mstrain" for the configuration's multi-scale range, every
  short side that `data/coco.sample_mstrain_scale` can return, or a list of
  [long, short] scales; each step's (scale, orientation) pair comes from a
  seeded permutation of all pairs, cycled, so a window holds each about
  equally often;
- `trace_units`: steps in the traced stretch of a `--trace 1` run.

Set-up draws the weights, builds the train state, and runs one step of
every (scale, orientation) pair through the window's own call and feed:
these are the run's first steps, and the reference follows the first
three (losses, the first gradient, the change after three steps) once
the window has closed and the program's state is freed. The window then
trains for `--seconds`, ending after `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_h100.harness import Context, Outcome, port_config, steady_window
from bench_h100.images import make_boxes, make_pool
from bench_h100.weights import make_state_dict

CHECKED_STEPS = 3
STEPS_PER_EPOCH = 7330             # the train state's default (COCO at 2 images a step x 8)


def scale_pairs(cfg: dict, tp: dict) -> List[Tuple[Tuple[int, int], bool]]:
    if tp["scales"] == "mstrain":
        (l1, s1), (l2, s2) = cfg["train"]["mstrain_range"]
        lo, hi = min(s1, s2), max(s1, s2)
        shorts = sorted({int(np.clip(round(s / 32) * 32, lo, hi)) for s in range(lo, hi + 1)})
        scales = [(max(l1, l2), s) for s in shorts]
    else:
        scales = [tuple(s) for s in tp["scales"]]
    return [(s, land) for s in scales for land in (True, False)]


class Feed:
    """The seed's steps: for step k, its (scale, orientation), its images,
    their boxes, labels and flips, and its sampling generator."""

    def __init__(self, cfg: dict, tp: dict, seed: int, stream: Optional[int] = None):
        self.tp, self.cfg = tp, cfg
        self.words = [seed] if stream is None else [seed, stream]    # a rank's own stream
        rng = np.random.default_rng(self.words)
        self.pool = make_pool(tp, self.words)
        self.gts = [make_boxes(img.shape[:2], rng, tp["gts"], cfg["num_classes"])
                    for img in self.pool]
        self.by_orient = {o: [i for i, im in enumerate(self.pool)
                              if (im.shape[1] >= im.shape[0]) == o] for o in (True, False)}
        pairs = scale_pairs(cfg, tp)
        self.pairs = [pairs[i] for i in rng.permutation(len(pairs))]

    def step(self, k: int):
        """Step k's scale, image ids (the next `batch` of its orientation's
        images, cycled) and flips."""
        scale, land = self.pairs[k % len(self.pairs)]
        before = sum(1 for i in range(k) if self.pairs[i % len(self.pairs)][1] == land)
        ids, b = self.by_orient[land], self.tp["batch"]
        picked = [ids[(before * b + j) % len(ids)] for j in range(b)]
        flips = np.random.default_rng(self.words + [k, 1]).random(b) < self.tp["flip_prob"]
        return scale, picked, [bool(f) for f in flips]

    def generator(self, k: int, device) -> torch.Generator:
        entropy = np.random.SeedSequence(self.words + [k]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(int(entropy))


class _Records:
    """The duck-typed dataset `make_train_batch` reads: one image per record."""

    def __init__(self, feed: Feed):
        self.feed = feed

    def load_image(self, rec):
        return self.feed.pool[rec.img_id]

    def record(self, i: int):
        from htd_tpu_torch.data.coco import ImageRecord

        img = self.feed.pool[i]
        boxes, labels = self.feed.gts[i]
        return ImageRecord(i, "", img.shape[0], img.shape[1], boxes, labels,
                           np.zeros((0, 4), np.float32))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().float().norm()) for k, v in tensors.items()}


def run(ctx: Context) -> Outcome:
    from htd_tpu_torch.data.coco import make_train_batch
    from htd_tpu_torch.train.train_step import train_step

    from bench_h100.program import build_train_state

    cell, tp = ctx.cell, ctx.cell.traffic
    doc = cell.config
    cfg = port_config(doc)
    dev = torch.device(ctx.device)
    step_fn = ctx.program or train_step
    feed = Feed(doc["config"], tp, ctx.seed)
    data = _Records(feed)
    state = build_train_state(cfg, make_state_dict(doc["config"], doc["assumed"], ctx.seed, dev),
                              dev)
    params = dict(state.model.named_parameters())

    def batch(k):
        scale, ids, flips = feed.step(k)
        return make_train_batch(data, [data.record(i) for i in ids], scale=scale,
                                max_gt=doc["config"]["train"]["max_gt"], flips=flips, device=dev)

    losses, first_grad = [], {}
    k = 0
    for k in range(max(len(feed.pairs), CHECKED_STEPS)):
        out = step_fn(state, batch(k), generator=feed.generator(k, dev))
        if k < CHECKED_STEPS:
            losses.append({name: float(v) for name, v in out.items()})
        if k == 0:
            first_grad = leaf_norms({n: p.grad for n, p in params.items() if p.grad is not None})
        if k == CHECKED_STEPS - 1:
            p0 = make_state_dict(doc["config"], doc["assumed"], ctx.seed, dev)
            change = leaf_norms({n: p.detach() - p0[n] for n, p in params.items()
                                 if p.requires_grad})
            del p0
    sync(dev)

    images, steps = 0, 0
    k += 1
    with steady_window():
        setup_s = time.perf_counter() - ctx.t0
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            step_fn(state, batch(k), generator=feed.generator(k, dev))
            images += tp["batch"]
            steps += 1
            k += 1
        sync(dev)
        window = time.perf_counter() - start

    tr, info = None, {}
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        from bench_h100.trace import from_profiler

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        traced = list(range(k, k + tp["trace_units"]))
        with profile(activities=acts) as prof:
            for j in traced:
                b = batch(j)
                with torch.profiler.record_function("bench.unit"):
                    step_fn(state, b, generator=feed.generator(j, dev))
                    sync(dev)
        tr = from_profiler(prof)
        info = {"config": doc["config"], "units_per_s": steps / window, "batch": tp["batch"],
                "window_buckets": [bucket(feed, j) for j in range(k - steps, k)],
                "unit_buckets": [bucket(feed, j) for j in traced]}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    notes = [f"steps {steps} images {images} in {window:.6f} s; set-up {setup_s:.3f} s "
             f"({max(len(feed.pairs), CHECKED_STEPS)} steps, one per scale and orientation); "
             f"first losses {[t['loss'] for t in losses]}"]
    numbers, want = judge(ctx, feed, (losses, first_grad, change), dev)
    if ctx.keep_pairs:
        info["readings"] = {"program": (losses, first_grad, change), "float32": want}
    return Outcome({"train_images_per_s": images / window, "setup_s": setup_s},
                   attempted=steps, failed=0, memory_peak_bytes=int(peak), numbers=numbers,
                   trace=tr, info=info, notes=notes)


def bucket(feed: Feed, k: int) -> Tuple[int, int]:
    from bench_h100.reference.ops import bucket_shape

    scale, land = feed.pairs[k % len(feed.pairs)]
    return bucket_shape(scale, land)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def moved(first_grad: Dict[str, float]) -> set:
    """The leaves whose first gradient in the reference is not nought to
    rounding: at least a thousandth of the median leaf's. The others (a
    bias under a softmax, say) move by round-off alone and are left out."""
    med = float(np.median(list(first_grad.values())))
    return {k for k, v in first_grad.items() if v >= 1e-3 * med}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep: set) -> Dict[str, float]:
    """Per kept leaf, the gap between two norms over the reference's norm
    of that leaf or of the median kept leaf, whichever is larger."""
    med = float(np.median([want[k] for k in keep]))
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med) for k in keep}


def reference_steps(doc: dict, feed: Feed, seed: int, dev, precision: str = "float32"):
    """The reference's first CHECKED_STEPS steps on the feed's batches:
    (each step's loss terms, the first gradient's leaf norms, the leaf
    norms of the change)."""
    from bench_h100.reference.ops import bucket_shape
    from bench_h100.reference.train import TrainReference, make_batch

    sd = make_state_dict(doc["config"], doc["assumed"], seed, dev)
    ref = TrainReference(doc["config"], sd, precision)
    p0 = {k: v.detach().clone() for k, v in ref.params().items()}
    losses, first = [], {}
    for k in range(CHECKED_STEPS):
        scale, ids, flips = feed.step(k)
        land = feed.pool[ids[0]].shape[1] >= feed.pool[ids[0]].shape[0]
        b = make_batch([feed.pool[i] for i in ids], [feed.gts[i][0] for i in ids],
                       [feed.gts[i][1] for i in ids], flips, scale, bucket_shape(scale, land),
                       doc["config"]["train"]["max_gt"], dev)
        terms, grads = ref.step_mean([b], [feed.generator(k, dev)], k, STEPS_PER_EPOCH)
        losses.append({name: float(v) for name, v in terms.items()})
        if k == 0:
            first = leaf_norms(grads)
    change = leaf_norms({k: v.detach() - p0[k] for k, v in ref.params().items()})
    return losses, first, change


def compare(got, want, dcn_leaves=()) -> Dict[str, float]:
    """Numbers between two (loss terms per step, first gradient, change)
    readings, over the leaves `moved` keeps.

    Compared (PERF.md gives their readings and limits):
    - `rpn_grad_gap`: the worst gap of the RPN head's leaves in the first
      gradient. They learn from the RPN loss alone, whose anchors, ground
      truth and draws are the same on both sides, so only arithmetic moves it;
    - `update_median_gap`: the median leaf's gap in the change after the
      checked steps;
    - `dcn_update_median_gap`: the same over the deformable convs' leaves.
    Reported, not compared: `loss_gap` (the worst step's relative gap of
    the total loss), `grad_gap` and `update_gap` (the worst leaf's). The
    RoI stages sample from the RPN's proposals, which differ between two
    precisions at the top-k and NMS cuts, so every leaf downstream of the
    RoI heads and every step's stage losses see other samples on each side."""
    keep = moved(want[1])
    first = leaf_gaps(got[1], want[1], keep)
    change = leaf_gaps(got[2], want[2], keep)
    out = {"rpn_grad_gap": max(v for k, v in first.items() if k.startswith("rpn_head.")),
           "update_median_gap": float(np.median(list(change.values())))}
    dcn = [change[k] for k in keep if k in set(dcn_leaves)]
    if dcn:
        out["dcn_update_median_gap"] = float(np.median(dcn))
    out.update(loss_gap=max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                            for a, b in zip(got[0], want[0])),
               grad_gap=max(first.values()), update_gap=max(change.values()))
    return out


def dcn_leaf_names(cfg: dict) -> List[str]:
    from bench_h100.reference.detector import dcn_convs

    return [n + s for n, *_ in dcn_convs(cfg)
            for s in (".weight", ".conv_offset.weight", ".conv_offset.bias")]


def judge(ctx: Context, feed: Feed, got, dev):
    """The numbers of the program's readings against the float32
    reference's, and the reference's readings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = reference_steps(ctx.cell.config, feed, ctx.seed, dev)
    return compare(got, want, dcn_leaf_names(ctx.cell.config["config"])), want
