"""Frozen operation and byte counts: functions of the configuration and the
bucket shape only, never of the program under test.

Conventions (PERF.md writes them down):
- a multiply-add is 2 operations; the model's operations are its
  convolutions and matrix products, as the published architecture
  defines them, at the configuration's RoI counts;
- a layer of the training step that trains costs its forward three times
  (forward, input gradient, weight gradient); frozen layers (the stem and
  the first `frozen_stages` stages) cost their forward once;
- bytes count each input read once and each output written once, in the
  dtype the configuration computes in.
"""

# published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates)
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
