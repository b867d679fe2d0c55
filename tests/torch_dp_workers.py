"""What the spawned processes of ``test_torch_data_parallel.py`` run (a
module of its own, torch only, so that the processes import no JAX)."""

import numpy as np
import torch

from torchmdnet_tpu_torch.datasets.memdataset import Dataset

TN_ARGS = dict(
    model="tensornet", embedding_dimension=16, num_layers=1, num_rbf=8,
    rbf_type="expnorm", trainable_rbf=False, activation="silu",
    cutoff_lower=0.0, cutoff_upper=5.0, max_z=100, max_num_neighbors=16,
    derivative=True, prior_model=None, output_model="Scalar",
    reduce_op="sum", precision=32, equivariance_invariance_group="O(3)",
    atom_filter=-1, tabulated_edge_mlp=0)
STEP_KW = dict(neg_dy_weight=0.5, ema_alpha_y=0.3, ema_alpha_neg_dy=0.6,
               gradient_clipping=0.2, lr_warmup_steps=3)


class Molecules(Dataset):
    """Seeded random molecules of 4-9 atoms with energies and forces."""

    def __init__(self, num_samples, seed=3):
        rng = np.random.RandomState(seed)
        self.samples = []
        for _ in range(num_samples):
            n = rng.randint(4, 10)
            self.samples.append(dict(
                z=rng.randint(1, 9, n).astype(np.int64),
                pos=rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
                y=rng.randn(1, 1), neg_dy=rng.randn(n, 3).astype(np.float32)))

    def __len__(self):
        return len(self.samples)

    def get(self, idx):
        return dict(self.samples[idx])


def batch(seed, mols=3):
    """A padded batch of ``mols`` molecules (ghost rows in segment
    ``mols``), as tensors."""
    rng = np.random.RandomState(seed)
    zs, ps, bs, fs = [], [], [], []
    for m in range(mols):
        n = rng.randint(4, 8)
        zs.append(rng.randint(1, 9, n))
        ps.append(rng.uniform(-2.5, 2.5, (n, 3)) + 20.0 * m)
        bs.append(np.full(n, m))
        fs.append(rng.randn(n, 3))
    zs.append(np.zeros(3, np.int64))
    ps.append(np.zeros((3, 3)))
    bs.append(np.full(3, mols))
    fs.append(np.zeros((3, 3)))
    f32 = torch.float32
    return dict(z=torch.as_tensor(np.concatenate(zs)),
                pos=torch.as_tensor(np.concatenate(ps), dtype=f32),
                batch=torch.as_tensor(np.concatenate(bs)),
                y=torch.as_tensor(rng.randn(mols, 1), dtype=f32),
                neg_dy=torch.as_tensor(np.concatenate(fs), dtype=f32),
                mol_mask=torch.ones(mols, dtype=torch.bool))


def dp_steps(rank, world_size, steps, out):
    """``steps`` data-parallel steps, rank ``r`` on batch ``r`` (seed
    ``10 r + step``); rank 0 saves the weights and each step's metrics."""
    from torchmdnet_tpu_torch.models.model import create_model
    from torchmdnet_tpu_torch.parallel.dp import (
        make_data_parallel_train_step)
    from torchmdnet_tpu_torch.train.step import create_train_state

    torch.set_num_threads(1)
    pot = create_model(TN_ARGS, device="cpu", seed=0)
    state = create_train_state(pot, lr=1e-2)
    step = make_data_parallel_train_step(pot, num_mols=3, **STEP_KW)
    metrics = []
    for s in range(steps):
        state, m = step(state, batch(10 * rank + s))
        metrics.append({k: float(v) for k, v in m.items()})
    if rank == 0:
        torch.save({"weights": pot.module.state_dict(), "metrics": metrics,
                    "ema": (float(state.ema_y), float(state.ema_neg_dy))},
                   out)
