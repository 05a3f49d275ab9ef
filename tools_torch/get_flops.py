#!/usr/bin/env python
"""Model parameters and forward FLOPs of the PyTorch port (after
tools/get_flops.py, which asks XLA's cost analysis).

Usage:
  python tools_torch/get_flops.py [--config htd_r50_1x] [--height 768 --width 1344]
      [--dtype bfloat16] [--device cpu]

Counts one `simple_test` of a (1, height, width, 3) input on the device
(CUDA unless `--device cpu`), random weights from seed 0:
- params: the model's parameter count;
- the aten ops that `torch.utils.flop_counter.FlopCounterMode` has
  formulas for (convolutions, matrix products), op by op;
- the port's custom ops, which run as kernels that the counter does not
  see (on the CPU their plain versions run outside the counter), by
  formula: K3's deformable conv, 2 * (Cin / groups) * k^2 * Cout per output
  pixel; K2's RoIAlign, 8 FLOPs (4 corners, a multiply and an add each)
  per channel per bilinear sample inside its feature map, the samples of
  this run's rois and adaptive grids.
Prints each part on its own line, then one JSON line with all of them.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="htd_r50_1x")
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--dtype", default=None,
                   help="compute_dtype override (e.g. bfloat16, the precision the serving path "
                        "runs in)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present); 'cpu' runs on "
                        "the CPU")
    return p.parse_args(argv)


def roi_align_flops(pyr, rois, lvls, strides, out_size, sampling_ratio, max_samples) -> int:
    """8 FLOPs per channel per bilinear sample inside its level's map, over
    the rois' adaptive grids (every level when `lvls` is None)."""
    import torch

    from htd_tpu_torch.ops.roi_align import _level_tables, _sample_geometry

    g = pyr.geom
    n = rois.shape[0] * rois.shape[1]
    flat = rois.reshape(n, 4).float()
    scale, hs, ws, _ = _level_tables(g, strides, flat.device)
    levels = [torch.full((n,), q, device=flat.device) for q in range(len(strides))] \
        if lvls is None else [lvls.reshape(n).long()]
    samples = 0
    for lv in levels:
        geo = _sample_geometry(flat, scale[lv], hs[lv], ws[lv], out_size, sampling_ratio,
                               max_samples)
        mx, xin, my, yin = geo[4], geo[5], geo[10], geo[11]
        samples += int(((my & yin).sum((1, 2)) * (mx & xin).sum((1, 2))).sum())
    return 8 * samples * g.channels


class CustomOpCounter:
    """Within `with`: the deformable conv and RoIAlign entry points that the
    model calls record their FLOPs by formula and run outside any
    FlopCounterMode (so that their plain versions' aten ops are not counted
    on the CPU, as the kernels are not on the card)."""

    def __init__(self):
        self.flops = {"deform_conv": 0, "roi_align": 0}
        self.calls = {"deform_conv": 0, "roi_align": 0}

    def __enter__(self):
        from torch.utils._python_dispatch import _disable_current_modes

        from htd_tpu_torch.models import roi_extract
        from htd_tpu_torch.ops import dcn

        self.saved = [(dcn, "deform_conv2d", dcn.deform_conv2d),
                      (roi_extract, "roi_align_pyramid", roi_extract.roi_align_pyramid),
                      (roi_extract, "roi_align_levels", roi_extract.roi_align_levels)]
        deform, pyramid, levels = (f for _, _, f in self.saved)

        def deform_conv2d(x, offsets, weight, stride=1, dilation=1, deform_groups=1, groups=1):
            kh, kw, cin_g, cout = weight.shape
            n, ho, wo = offsets.shape[:3]
            self.flops["deform_conv"] += 2 * n * ho * wo * cin_g * kh * kw * cout
            self.calls["deform_conv"] += 1
            with _disable_current_modes():
                return deform(x, offsets, weight, stride, dilation, deform_groups, groups)

        def roi_align_pyramid(pyr, rois, lvls, strides, out_size=7, sampling_ratio=0,
                              max_samples=4):
            self.flops["roi_align"] += roi_align_flops(pyr, rois, lvls, strides, out_size,
                                                       sampling_ratio, max_samples)
            self.calls["roi_align"] += 1
            with _disable_current_modes():
                return pyramid(pyr, rois, lvls, strides, out_size, sampling_ratio, max_samples)

        def roi_align_levels(pyr, rois, strides, out_size=7, sampling_ratio=0, max_samples=1):
            self.flops["roi_align"] += roi_align_flops(pyr, rois, None, strides, out_size,
                                                       sampling_ratio, max_samples)
            self.calls["roi_align"] += 1
            with _disable_current_modes():
                return levels(pyr, rois, strides, out_size, sampling_ratio, max_samples)

        dcn.deform_conv2d = deform_conv2d
        roi_extract.roi_align_pyramid = roi_align_pyramid
        roi_extract.roi_align_levels = roi_align_levels
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def count(cfg, height: int, width: int, device=None) -> dict:
    """Params and forward FLOPs of one `simple_test` of `cfg` at height x
    width: {"params", "aten": {op: flops}, "aten_total", "deform_conv",
    "roi_align", "total", "calls": custom-op calls}."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from htd_tpu_torch.apis import init_detector

    model = init_detector(cfg, device=device, seed=0)
    dev = model.device
    images = torch.zeros((1, height, width, 3), device=dev, dtype=model.compute_dtype)
    shapes = torch.tensor([[height - 18.0, width - 11.0]], device=dev)
    sfs = torch.ones((1, 4), device=dev)
    with torch.inference_mode():
        model.simple_test(images, shapes, sfs)          # warm: cuDNN's first calls
    # with autograd on: the counter's module tracker hooks the parameters' graph
    with CustomOpCounter() as custom, FlopCounterMode(display=False) as counter:
        model.simple_test(images, shapes, sfs)
    aten = {str(op): int(v) for op, v in counter.get_flop_counts()["Global"].items()}
    out = {"params": sum(p.numel() for p in model.parameters()), "aten": aten,
           "aten_total": int(counter.get_total_flops()), **custom.flops,
           "calls": custom.calls}
    out["total"] = out["aten_total"] + out["deform_conv"] + out["roi_align"]
    return out


def main(argv=None):
    """Prints the counts; returns them (`count`'s dict)."""
    args = parse_args(argv)
    from htd_tpu_torch import config as C

    cfg = getattr(C, args.config)()
    if args.dtype:
        cfg = cfg.replace(compute_dtype=args.dtype)
    out = count(cfg, args.height, args.width, args.device)
    print(f"params: {out['params'] / 1e6:.2f} M")
    for op, v in sorted(out["aten"].items()):
        print(f"  {op}: {v / 1e9:.2f} GFLOPs (FlopCounterMode)")
    print(f"aten ops (FlopCounterMode): {out['aten_total'] / 1e9:.2f} GFLOPs")
    print(f"deformable conv (K3, by formula, {out['calls']['deform_conv']} calls): "
          f"{out['deform_conv'] / 1e9:.2f} GFLOPs")
    print(f"RoIAlign (K2, by formula, {out['calls']['roi_align']} calls): "
          f"{out['roi_align'] / 1e9:.2f} GFLOPs")
    print(f"forward flops: {out['total'] / 1e9:.2f} GFLOPs at {args.height}x{args.width}, "
          f"{cfg.compute_dtype}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
