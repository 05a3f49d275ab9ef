"""Faults planted in the timed path, for the tests that see `correct` come
out false and for the fault readings of `control.py`: each wraps the
program's own entry and breaks what it returns or what it does."""

from __future__ import annotations


def altered_labels(model, img):
    """A detection altered where it is produced: every label moved on by one."""
    from htd_tpu_torch.apis import inference_detector

    b, s, lab = inference_detector(model, img)
    return b, s, (lab + 1) % model.cfg.num_classes


def altered_scores(model, img):
    """Every score halved."""
    from htd_tpu_torch.apis import inference_detector

    b, s, lab = inference_detector(model, img)
    return b, s * 0.5, lab


def dropped_detections(model, img):
    """No detection returned."""
    from htd_tpu_torch.apis import inference_detector

    b, s, lab = inference_detector(model, img)
    return b[:0], s[:0], lab[:0]


def top_half(model, img):
    """The detections cut early: only the better-scored half returned."""
    from htd_tpu_torch.apis import inference_detector

    b, s, lab = inference_detector(model, img)
    keep = (-s).argsort(kind="stable")[:len(s) // 2]
    return b[keep], s[keep], lab[keep]


def shifted_boxes(model, img):
    """Every box moved 4 pixels to the right."""
    from htd_tpu_torch.apis import inference_detector

    b, s, lab = inference_detector(model, img)
    b = b.copy()
    b[:, 0::2] += 4.0
    return b, s, lab


def relabelled_fifth(model, img):
    """Every fifth detection's label moved on by one."""
    from htd_tpu_torch.apis import inference_detector

    b, s, lab = inference_detector(model, img)
    lab = lab.copy()
    lab[::5] = (lab[::5] + 1) % model.cfg.num_classes
    return b, s, lab


def state_unchanged(state, batch, generator=None, group=None):
    """A step that returns its state unchanged: forward and backward, no update."""
    from htd_tpu_torch.train.train_step import train_step

    step = state.optimizer.step
    state.optimizer.step = lambda *a, **k: None
    try:
        return train_step(state, batch, generator=generator, group=group)
    finally:
        state.optimizer.step = step


def half_batch(state, batch, generator=None, group=None):
    """Half of the batch left out, the mean taken over the rest."""
    from htd_tpu_torch.train.train_step import TrainBatch, train_step

    n = batch.images.shape[0] // 2
    return train_step(state, TrainBatch(*(t[:n] for t in batch)), generator=generator,
                      group=group)


def no_exchange(state, batch, generator=None, group=None):
    """The exchange between cards left out: each rank steps on its own
    gradient."""
    from htd_tpu_torch.train.train_step import train_step

    return train_step(state, batch, generator=generator)


def loads_jax(state, batch, generator=None, group=None):
    """A sound step in a process that has a module named jax loaded: the
    run's import check has to catch it in every process that trains."""
    import sys
    import types

    from htd_tpu_torch.train.train_step import train_step

    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return train_step(state, batch, generator=generator, group=group)


INFERENCE = (altered_labels, altered_scores, dropped_detections, top_half, shifted_boxes,
             relabelled_fifth)
TRAINING = (state_unchanged, half_batch)
DATA_PARALLEL = (state_unchanged, half_batch, no_exchange)
