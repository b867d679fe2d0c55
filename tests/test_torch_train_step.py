"""The port's train step (``bench.py::bench_train``'s, at a small width)
against JAX ``make_train_step`` on the CPU, with tabulated filters
(T=16): the force pass and its parameter gradient run the Chebyshev
filter, filter-dot and projection through their backwards.  Three steps
from the same weights on a batch with ghost rows, with warmup, EMA,
weight decay, clipping and loss weights all on: every step's losses and
the updated weights at rtol = atol = 1e-4, and the gradients the first
update hands AdamW within 1e-4 of each gradient's max |·| (one jitted JAX
run per file; ``test_torch_train_step_exact.py`` holds the exact
variant)."""

import pytest

from torch_parity import (TRAIN_ARGS, TRAIN_GROUPS, TRAIN_HP,
                          check_ghost_rows_inert, check_train_grads,
                          check_train_losses, check_train_weights,
                          one_torch_thread,  # noqa: F401
                          train_batch, train_steps_jax, train_steps_port)

ARGS = dict(TRAIN_ARGS, tabulated_edge_mlp=16)
HP = TRAIN_HP["all_on"]

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
