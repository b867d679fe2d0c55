"""PyTorch/CUDA port of ``torchmdnet_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``torchmdnet_tpu`` is the reference this package is held
against.  This package imports ``torch`` and ``numpy`` only; its
hand-written kernels live in ``csrc/*.cu`` and are built with ``nvcc`` on
first use (``ops/kernels.py``).
"""

from torchmdnet_tpu_torch.models.model import (
    Ensemble, Potential, create_model, load_ensemble, load_model)
from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint

__all__ = ["Ensemble", "Potential", "create_model", "load_ensemble",
           "load_model", "save_checkpoint"]
