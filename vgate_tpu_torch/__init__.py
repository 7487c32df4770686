"""vgate-tpu's PyTorch/CUDA port: the serving engine of ``vgate_tpu``
rewritten in PyTorch, with its TPU kernels rewritten by hand for NVIDIA
Hopper (``csrc/``).  It imports neither JAX nor ``vgate_tpu``."""

from vgate_tpu_torch.version import __version__

__all__ = ["__version__"]
