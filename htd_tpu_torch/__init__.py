"""htd_tpu_torch: HTD inference, test-time augmentation, evaluation and
training in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

The port of `htd_tpu` (JAX, TPU). It imports neither JAX nor anything of
`htd_tpu`; the JAX package is the reference its tests hold it to.
"""

from htd_tpu_torch.apis import (aug_inference_detector, calibrate_dcn,  # noqa: F401
                                evaluate_dataset, evaluate_proposals, inference_detector,
                                init_detector)
from htd_tpu_torch.config import (htd_detectors_r50_1x, htd_r50_1x,  # noqa: F401
                                   htd_r101_2x, htd_r101_dcn_2x, htd_x101_dcn_2x)
from htd_tpu_torch.train.train_step import (TrainBatch, TrainState,  # noqa: F401
                                            create_train_state, train_step)
