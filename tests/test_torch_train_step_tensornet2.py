"""The port's train step on a tiny model of the AceFF recipe
(``examples/TensorNet2-AceFF.yaml``: TensorNet2 with charge equilibration,
``charge: true``, the all-to-all Coulomb head) against JAX
``make_train_step`` on the CPU, both kernel flags on: the force pass runs
the radial embedding's backward (kernel 2's op) and kernel 3's op, and
the weights' gradient differentiates both once more (the plain double vjp
in the port, the jnp one in JAX).  Three steps from the same weights on a
batch of three molecules with total charges 1, 0 and −1 and ghost rows,
with warmup, EMA, weight decay, clipping and loss weights on: every
step's losses and the updated weights at rtol = atol = 1e-4, and the
gradients the first update hands AdamW within 1e-4 of each gradient's
max |·| (one jitted JAX run for the file).  Before the embedding and the
edge MLP were differentiable twice, the gradients lost their
second-order terms without a word."""

import pytest

from torch_parity import (TRAIN_HP, check_ghost_rows_inert,
                          check_train_grads, check_train_losses,
                          check_train_weights,
                          one_torch_thread,  # noqa: F401
                          train_batch, train_steps_jax, train_steps_port)

# the AceFF recipe at 2 x 16, q_dim 4, 8 rbf, 5 Å, K = 16
ARGS = dict(
    model="tensornet2", embedding_dimension=16, num_layers=2, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=5.0, max_z=128, max_num_neighbors=16,
    derivative=True, prior_model=None, reduce_op="sum", precision=32,
    equivariance_invariance_group="O(3)", atom_filter=-1, q_dim=4,
    output_model="ScalarPlusWeightedCoulomb", q_weights=[[1.0] * 4] * 3,
    coulomb_cutoff=None, pallas_embedding=True, pallas_edge_mlp=True)
HP = dict(TRAIN_HP["all_on"], neg_dy_weight=10.0)
Q = (1.0, 0.0, -1.0)
GROUPS = ("representation_model.tensor_embedding",
          "representation_model.layers.0", "representation_model.layers.1",
          "representation_model.charge_predict_0",
          "representation_model.charge_predicts",
          "representation_model.out_norm", "representation_model.linear",
          "output_model")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runs():
    batch = train_batch(q=Q)
    want = train_steps_jax(ARGS, HP, batch)
    return want, train_steps_port(ARGS, HP, batch, want[0])


def test_losses_match_jax(runs):
    check_train_losses(*runs)


def test_first_step_gradients_match_jax(runs):
    for group in GROUPS:
        check_train_grads(*runs, group)


def test_updated_weights_match_jax(runs):
    for group in GROUPS:
        check_train_weights(*runs, group)


def test_ghost_rows_inert(runs):
    check_ghost_rows_inert(ARGS, runs[0][0], q=Q)
