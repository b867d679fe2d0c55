"""The port's train step on the Equivariant Transformer against JAX
``make_train_step`` on the CPU: three steps from the same weights on a
batch of three molecules with ghost rows (``torch_parity.py::
train_batch``), with the ET-MD17 recipe's loss weights (y 0.2, neg_dy
0.8) and its y EMA (0.05).  Every step's losses at rtol = atol = 1e-4,
the gradients the first update hands AdamW within 1e-4 of each
gradient's max |·|, and the updated weights at rtol = atol = 1e-4 but
where Adam cannot resolve the sign: an element whose first gradient is
not zero but within float32 round-off of it (below 1e-6 of its tensor's
max |g|;
here one of 1,024 in the head, 4.2e-9 in JAX and −5.4e-9 in the port
against a max of 0.08) moves by ±lr whatever its size, so it is held to
the lr · steps that Adam bounds it by.  Every op of ET is plain PyTorch,
so the force pass's second order comes from autograd (one jitted JAX
run)."""

import numpy as np
import pytest

from torch_parity import (ATOL, ET_ARGS, RTOL, TRAIN_HP, TRAIN_STEPS,
                          check_train_grads, check_train_losses,
                          one_torch_thread,  # noqa: F401
                          train_batch, train_steps_jax, train_steps_port)
from torchmdnet_tpu_torch.utils.jax_params import params_from_jax

ARGS = dict(ET_ARGS, cutoff_upper=5.0)
HP = dict(TRAIN_HP["default"], y_weight=0.2, neg_dy_weight=0.8,
          ema_alpha_y=0.05)
GROUPS = ("representation_model.embedding",
          "representation_model.neighbor_embedding",
          "representation_model.attention_layers.0",
          "representation_model.attention_layers.1",
          "representation_model.out_norm", "output_model")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runs():
    batch = train_batch()
    want = train_steps_jax(ARGS, HP, batch)
    return want, train_steps_port(ARGS, HP, batch, want[0])


def test_losses_match_jax(runs):
    check_train_losses(*runs)


@pytest.mark.parametrize("group", GROUPS[1:])
def test_first_step_gradients_match_jax(runs, group):
    check_train_grads(*runs, group)


def test_updated_weights_match_jax(runs):
    (flat0, _, flat_j, grads), (_, sd_t, _) = runs
    sd_0, sd_j, g_j = (params_from_jax(f) for f in (flat0, flat_j, grads))
    assert sd_t.keys() == sd_j.keys()
    excused = 0
    for group in GROUPS:
        keys = [k for k in sd_j if k.startswith(group + ".")]
        assert keys
        assert max(float((sd_j[k] - sd_0[k]).abs().max())
                   for k in keys) > 10 * ATOL  # training moved them
        for key in keys:
            want, got, g = sd_j[key].numpy(), sd_t[key], g_j[key].numpy()
            unresolved = (g != 0) & (np.abs(g) < 1e-6 * np.abs(g).max())
            err = np.abs(got - want)
            off = err > ATOL + RTOL * np.abs(want)
            assert not (off & ~unresolved).any(), key
            assert err[off].max(initial=0.0) <= HP["lr"] * TRAIN_STEPS, key
            excused += int(off.sum())
    assert excused <= 2  # one element in this run
