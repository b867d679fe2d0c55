"""The port's train step against JAX ``make_train_step`` on the CPU in
``bench.py::bench_train``'s exact default (``tabulated_edge_mlp=0``: the
edge MLP and the embedding as plain chains, no kernel): three steps from
the same weights on a batch with ghost rows with the default
hyperparameters, every step's losses and the updated weights at rtol =
atol = 1e-4, and the first update's gradients within 1e-4 of each
gradient's max |·| (one jitted JAX run per file)."""

import pytest

from torch_parity import (TRAIN_ARGS, TRAIN_GROUPS, TRAIN_HP,
                          check_ghost_rows_inert, check_train_grads,
                          check_train_losses, check_train_weights,
                          one_torch_thread,  # noqa: F401
                          train_batch, train_steps_jax, train_steps_port)

ARGS = dict(TRAIN_ARGS, tabulated_edge_mlp=0)
HP = TRAIN_HP["default"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runs():
    batch = train_batch()
    want = train_steps_jax(ARGS, HP, batch)
    return want, train_steps_port(ARGS, HP, batch, want[0])


def test_losses_match_jax(runs):
    check_train_losses(*runs)


@pytest.mark.parametrize("group", TRAIN_GROUPS)
def test_first_step_gradients_match_jax(runs, group):
    check_train_grads(*runs, group)


@pytest.mark.parametrize("group", TRAIN_GROUPS)
def test_updated_weights_match_jax(runs, group):
    check_train_weights(*runs, group)


def test_ghost_rows_inert(runs):
    check_ghost_rows_inert(ARGS, runs[0][0])
