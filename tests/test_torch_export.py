"""Export (``utils/export.py``, JAX ``utils/export.py``) on the CPU: the
``torch.export`` program of ``pos -> (E, F)`` round-trips through bytes
and a file and matches ``Potential.apply`` to 1e-5 at its frozen shapes
(TensorNet2 with the charge head's ``q`` in a periodic box); and the
dispatcher operators of kernels 1-4, which the
program calls on the card, have shape functions that give their eager
outputs' shapes (``torch.library.opcheck`` for the three that take CPU
tensors; kernel 2's operator is CUDA only, its shape function is held
against the plain backward).  torch only: no JAX model is compiled."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from torch_parity import SMALL_ARGS, one_torch_thread  # noqa: F401
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops import edge_mlp, radial_embedding
from torchmdnet_tpu_torch.utils.export import export_potential, load_exported

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def molecules(n, seed):
    rng = np.random.RandomState(seed)
    z = rng.choice([1, 6, 7, 8], n)
    pos = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    return z, pos


def test_export_round_trip(tmp_path):
    """TensorNet2 with the charge head's ``q`` and its Coulomb list, two
    molecules in a periodic box: the program, written to a file and read
    back, gives the direct call's energies and forces at the exported
    positions and at moved ones, to 1e-5."""
    args = dict(SMALL_ARGS, embedding_dimension=8, num_layers=1, num_rbf=8,
                max_num_neighbors=12, q_dim=4, q_weights=[[1.0] * 4] * 2)
    z, pos = molecules(10, 0)
    batch, q = np.repeat([0, 1], 5), np.array([0.0, 1.0])
    box = np.diag([11.0, 11.5, 12.0])
    pot = create_model(args, device="cpu", seed=1)
    path = tmp_path / "model.pt2"
    blob = export_potential(pot, z, batch, num_mols=2, box=box, q=q,
                            path=str(path))
    assert path.read_bytes() == blob
    run = load_exported(str(path))
    rng = np.random.RandomState(2)
    for p in (pos, pos + rng.uniform(-0.1, 0.1, pos.shape)):
        p = torch.as_tensor(p, dtype=torch.float32)
        y, f = run(p)
        y_ref, f_ref = pot.apply(z, p, batch, num_mols=2, box=box, q=q)
        assert y.shape == (2, 1) and f.shape == p.shape
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(f_ref.abs().max()))


def embedding_inputs(n=6, k=5, r=8, f=6, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g)

    mask = (torch.rand(n, k, generator=g) > 0.3).float()
    return (rand(n, k, r), rand(n, k), rand(n, k), rand(n, k), rand(n, k),
            rand(n, f), rand(n, k, f), mask, rand(r, 3 * f), rand(3 * f))


def test_kernel_operators_opcheck():
    """Kernels 1, 3 and 4's operators on CPU tensors (their plain chains):
    schema, shape function and the dispatcher's checks, at an odd F; and
    each returns its plain chain's values."""
    emb = embedding_inputs()
    n, k, f = 6, 5, 6
    g = torch.Generator().manual_seed(1)
    x, pre1, cw = (torch.randn(n, k, 7, generator=g),
                   torch.randn(n, k, f, generator=g),
                   torch.rand(n, k, generator=g))
    w = [torch.randn(*s, generator=g) for s in ((7, f), (f,), (f, 2 * f),
                                                (2 * f,), (2 * f, 3 * f),
                                                (3 * f,))]
    cases = [(radial_embedding.radial_embedding_fwd_op, emb,
              radial_embedding.radial_embedding_ref),
             (edge_mlp.edge_mlp_op, (x, cw, *w), edge_mlp.edge_mlp_ref),
             (edge_mlp.edge_mlp_pre_op, (pre1, cw, *w[2:]),
              edge_mlp.edge_mlp_pre_ref)]
    for op, args, ref in cases:
        torch.library.opcheck(op, args, test_utils=(
            "test_schema", "test_faketensor", "test_autograd_registration"))
        assert torch.equal(op(*args), ref(*args))


@pytest.mark.parametrize("want_dz, want_dk", [(False, False), (True, False),
                                              (True, True)])
def test_kernel2_operator_shapes(want_dz, want_dk):
    """Kernel 2's shape function against the plain backward's outputs:
    the nine cotangents, an empty tensor for each one not asked for."""
    emb = embedding_inputs()
    g = torch.randn(6, 9 * 6)
    needs = [True] * 5 + [want_dz] * 2 + [False] + [want_dk] * 2
    want = radial_embedding.radial_embedding_bwd_ref(emb, g, needs)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in (*emb, g)]
        got = torch.ops.tmdnet.radial_embedding_bwd(*fake, want_dz, want_dk)
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert tuple(a.shape) == ((0,) if b is None else tuple(b.shape))
