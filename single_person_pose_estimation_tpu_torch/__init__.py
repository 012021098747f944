"""PyTorch and CUDA port of the stacked-hourglass pose estimator.

The JAX package `single_person_pose_estimation_tpu` is the reference; this
package computes the same functions with PyTorch tensors, and runs the hot
loops of inference, evaluation and training through hand-written CUDA
kernels (`ops/cuda/`) on an NVIDIA Hopper card. It imports neither JAX nor
any module of the JAX package: what it needs of that package's
framework-free modules (`Config`, the training metrics files, the record
codec and image helpers, OKS and PCK) it keeps as its own copies.
"""

from single_person_pose_estimation_tpu_torch.configs.default_config import Config

__all__ = ["Config"]
