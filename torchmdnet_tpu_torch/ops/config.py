"""Numerics and device configuration.

Counterpart of ``torchmdnet_tpu/ops/config.py``.  JAX's matmul precision
names map onto PyTorch's TF32 switches: ``"highest"`` keeps every float32
matmul and convolution in full float32 (TF32 off for both cuBLAS and
cuDNN) — the setting the 1e-4 parity contract needs; ``"high"`` and
``"default"`` allow TF32.
"""

import torch

_PRECISIONS = ("highest", "high", "default")


def set_matmul_precision(name: str) -> None:
    if name not in _PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {list(_PRECISIONS)}")
    tf32 = name != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


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
