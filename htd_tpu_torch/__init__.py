"""htd_tpu_torch: HTD inference in PyTorch, with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

The port of `htd_tpu` (JAX, TPU). It imports neither JAX nor anything of
`htd_tpu`; the JAX package is the reference its tests hold it to.
"""

from htd_tpu_torch.apis import inference_detector, init_detector  # noqa: F401
from htd_tpu_torch.config import (htd_r50_1x, htd_r101_2x, htd_r101_dcn_2x,  # noqa: F401
                                   htd_x101_dcn_2x)
