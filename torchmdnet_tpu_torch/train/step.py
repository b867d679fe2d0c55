"""The training step (counterpart of ``torchmdnet_tpu/train/step.py``,
reference ``torchmdnet/module.py`` LNNP).

One step: energy and forces with the force graph kept
(``Potential.apply(..., create_graph=True)``), the weighted masked y /
neg_dy losses, the EMA smoothing that enters the backward (reference
``module.py:224-240``: ``α·loss + (1 − α)·stopgrad(ema)``, so gradients
scale by α), the gradient in the parameters through the force pass
(second order), optional global-norm clipping as optax does it, the LR
warmup written into the param group (``module.py:295-307``) and one
``torch.optim.AdamW`` update.  AdamW and optax's ``adamw`` are the same
update: decoupled decay on the old parameter, ``eps`` outside the square
root, bias corrections on both moments.
"""

from dataclasses import dataclass

import torch

from torchmdnet_tpu_torch.train.loss import LOSS_FUNCTIONS


@dataclass
class TrainState:
    """The module (its parameters are the trained ones), its optimizer,
    the global step, the plateau-scheduled base LR (warmup goes on top)
    and the EMAs of the y and neg_dy train losses (0-d tensors on the
    module's device; −1 = not yet set)."""
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    base_lr: float
    ema_y: torch.Tensor
    ema_neg_dy: torch.Tensor

    @property
    def params(self):
        return list(self.module.parameters())


def make_optimizer(params, weight_decay: float = 0.0):
    """AdamW with the LR set by the step (reference ``module.py:120-127``;
    optax's defaults b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: every gradient becomes
    ``g / ‖g‖ · max_norm`` when the global norm ``‖g‖`` is not below
    ``max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm; optax does
    not)."""
    norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def create_train_state(potential, *, lr: float, weight_decay: float = 0.0):
    """Turn the gradients of ``potential``'s weights on and pair them with
    a fresh optimizer."""
    module = potential.module
    module.requires_grad_(True)
    dev = next(module.parameters()).device
    unset = torch.tensor(-1.0, device=dev)
    return TrainState(module=module,
                      optimizer=make_optimizer(module.parameters(),
                                               weight_decay),
                      step=0, base_lr=float(lr), ema_y=unset,
                      ema_neg_dy=unset.clone())


def batch_losses(loss_fn_name, y, neg_dy, batch, num_mols: int):
    """``(loss_y, loss_neg_dy)`` of predictions on one padded batch: the
    masked loss of y over ``mol_mask`` and of neg_dy over the real atoms
    (``batch < num_mols``); 0 for a target the batch does not carry."""
    loss_fn = LOSS_FUNCTIONS[loss_fn_name]
    loss_y = loss_neg_dy = torch.zeros((), dtype=y.dtype, device=y.device)
    if batch.get("y") is not None:
        loss_y = loss_fn(y, batch["y"].reshape(y.shape), batch.get("mol_mask"))
    if neg_dy is not None and batch.get("neg_dy") is not None:
        loss_neg_dy = loss_fn(neg_dy, batch["neg_dy"],
                              batch["batch"] < num_mols)
    return loss_y, loss_neg_dy


def compute_losses(potential, batch, num_mols: int,
                   loss_fn_name: str = "mse_loss", create_graph=False):
    """The unweighted y / neg_dy losses of one padded batch:
    ``(loss_y, loss_neg_dy, (y, neg_dy))``.

    ``batch`` keys: z [N], pos [N, 3], batch [N] (ghost atoms in segment
    ``num_mols``), mol_mask [B], and optionally y [B, 1], neg_dy [N, 3],
    q [B], box, extra_args (what the priors read).  ``create_graph`` keeps
    the graph of the forces (for a gradient in the parameters)."""
    y, neg_dy = potential.apply(
        batch["z"], batch["pos"], batch["batch"], num_mols=num_mols,
        box=batch.get("box"), q=batch.get("q"),
        extra_args=batch.get("extra_args"), create_graph=create_graph)
    loss_y, loss_neg_dy = batch_losses(loss_fn_name, y, neg_dy, batch,
                                       num_mols)
    return loss_y, loss_neg_dy, (y, neg_dy)


def _smooth(loss, ema, alpha):
    """``(smoothed loss, new EMA)``: ``α·loss + (1 − α)·ema`` with the
    EMA outside the graph and set to the loss on first use; the loss
    itself when α is not in (0, 1)."""
    if not 0.0 < alpha < 1.0:
        return loss, loss.detach()
    prev = torch.where(ema < 0, loss.detach(), ema)
    sm = alpha * loss + (1.0 - alpha) * prev
    return sm, sm.detach()


def make_train_step(potential, *, num_mols: int, y_weight: float = 1.0,
                    neg_dy_weight: float = 1.0, lr_warmup_steps: int = 0,
                    ema_alpha_y: float = 1.0, ema_alpha_neg_dy: float = 1.0,
                    train_loss: str = "mse_loss",
                    gradient_clipping: float = 0.0, average=None):
    """``(state, batch) -> (state, metrics)``: one update of
    ``state.module``'s parameters in place (see the module docstring).
    ``metrics`` holds 0-d tensors ``loss``, ``loss_y``, ``loss_neg_dy``
    and the float ``lr`` the update used.  ``average`` (data parallelism,
    ``parallel/dp.py``) replaces a list of tensors by their means over
    the replicas in place; it gets the gradients and the step's scalars
    (the losses, the total and the new EMAs) before the clipping, where
    JAX ``pmean``s them (``:152-154``)."""
    clip = float(gradient_clipping or 0.0)

    def train_step(state: TrainState, batch):
        params = state.params
        loss_y, loss_neg_dy, _ = compute_losses(potential, batch, num_mols,
                                                train_loss, create_graph=True)
        sm_y, ema_y = _smooth(loss_y, state.ema_y, ema_alpha_y)
        sm_neg, ema_neg = _smooth(loss_neg_dy, state.ema_neg_dy,
                                  ema_alpha_neg_dy)
        total = y_weight * sm_y + neg_dy_weight * sm_neg
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # a weight the loss does not reach gets a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if average is not None:
            aux = [t.detach().clone() for t in (loss_y, loss_neg_dy, total,
                                                ema_y, ema_neg)]
            average(grads + aux)
            loss_y, loss_neg_dy, total, ema_y, ema_neg = aux
        if clip > 0:
            clip_by_global_norm_(grads, clip)
        scale = (min(1.0, (state.step + 1.0) / lr_warmup_steps)
                 if lr_warmup_steps > 0 else 1.0)
        lr = state.base_lr * scale
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g
        state.optimizer.step()
        for p in params:
            p.grad = None
        state.step += 1
        state.ema_y, state.ema_neg_dy = ema_y, ema_neg
        return state, dict(loss=total.detach(), loss_y=loss_y.detach(),
                           loss_neg_dy=loss_neg_dy.detach(), lr=lr)

    return train_step
