"""Numerics and device configuration.

Counterpart of ``torchmdnet_tpu/ops/config.py``.  JAX's matmul precision
names map onto PyTorch's TF32 switches (cuBLAS matmuls and cuDNN
convolutions together):

* ``"highest"`` and ``"high"``: full float32, TF32 off.  JAX's ``"high"``
  (bf16_3x) keeps ~1e-6 relative error; TF32 rounds the inputs to 10
  mantissa bits (~5e-4), so it cannot stand in for it.
* ``"default"``: TF32 allowed, the nearest thing to JAX's single-pass
  bf16.

The port starts at ``"highest"``; the setting changes only through
:func:`set_matmul_precision` (``create_model`` calls it when its args
name a precision, as the JAX package's does).
"""

import torch

_PRECISIONS = ("highest", "high", "default")


def set_matmul_precision(name: str) -> None:
    if name not in _PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {list(_PRECISIONS)}")
    tf32 = name == "default"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


set_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Never moves to the CPU on its own: with no device given and no CUDA
    available this raises; pass ``device="cpu"`` to run on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but CUDA is not available")
    return device
