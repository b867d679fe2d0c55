"""PyTorch/CUDA port of ``torchmdnet_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``torchmdnet_tpu`` is the reference this package is held
against.  This package imports ``torch`` and ``numpy`` only; its
hand-written kernels live in ``csrc/*.cu`` and are built with ``nvcc`` on
first use (``ops/kernels.py``).
"""

from torchmdnet_tpu_torch.models.model import Potential, create_model

__all__ = ["Potential", "create_model"]
