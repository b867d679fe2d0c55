"""Masked losses (counterpart of ``torchmdnet_tpu/train/loss.py``).

Batches are padded to static shapes, so each loss takes a mask (ghost
atoms, padded molecules) and averages over the valid elements only; the
mean divides by ``max(Σmask, 1)``.
"""

import torch


def _masked_mean(err, mask):
    if mask is None:
        return err.mean()
    mask = mask.reshape(mask.shape + (1,) * (err.dim() - mask.dim()))
    mask = mask.expand(err.shape).to(err.dtype)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_mse(pred, target, mask=None):
    return _masked_mean((pred - target) ** 2, mask)


def masked_l1(pred, target, mask=None):
    return _masked_mean((pred - target).abs(), mask)


def masked_huber(pred, target, mask=None, delta: float = 1.0):
    err = (pred - target).abs()
    quad = torch.clamp(err, max=delta)
    return _masked_mean(0.5 * quad * quad + delta * (err - quad), mask)


LOSS_FUNCTIONS = {
    "mse_loss": masked_mse,
    "l1_loss": masked_l1,
    "huber_loss": masked_huber,
}
