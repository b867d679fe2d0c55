"""The port's grouped tuner (``tune_cell_block_spec(column_slots=True)``)
against the JAX package's: the per-column slot budgets of the grouped
tier's K′ list on the same positions."""

import jax.numpy as jnp
import pytest

from torch_parity import blocked_system, one_torch_thread
from torchmdnet_tpu.ops import cell_blocks as jcb
from torchmdnet_tpu_torch.ops import cell_blocks as tcb

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("cutoff,cap", [(3.2, 8), (3.7, 16)])
def test_tuned_column_slots_equal_jax(cutoff, cap):
    pos, bd = blocked_system(seed=5)
    want = jcb.tune_cell_block_spec(jnp.asarray(pos), jnp.asarray(bd),
                                    cutoff, cap=cap, column_slots=True)
    got = tcb.tune_cell_block_spec(pos, bd, cutoff, cap=cap,
                                   column_slots=True)
    assert got.col_slots == want.col_slots and len(got.col_slots) == 9
    for key in ("nx", "ny", "nzf", "cap", "n_pad", "cut_bins"):
        assert getattr(got, key) == getattr(want, key), key
    assert tcb.CellBlockSpec(**want._asdict()).col_slots == want.col_slots
