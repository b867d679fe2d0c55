"""The port stands alone: no module of ``torchmdnet_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax, the JAX package or the
repo-root ``csrc`` build helper, and none imports yaml, h5py or ase but
the readers of those formats and the ASE calculator, inside the
functions that use them; the entry points never fall back to the CPU on
their own; and every module of the JAX package has a counterpart of the
same path in the port, but those listed as not to port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    SMALL_ARGS, TENSORNET_ARGS, one_torch_thread)
from torchmdnet_tpu_torch.md.integrators import (
    make_adaptive_md_step, make_md_step, run_md)
from torchmdnet_tpu_torch.models.model import create_model
from torchmdnet_tpu_torch.ops.cell_blocks import make_cell_block_spec
from torchmdnet_tpu_torch.ops.config import resolve_device, set_matmul_precision

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
# yaml and h5py too: the card's machine may have neither; build_ext is the
# JAX package's packer build (the port builds its own copy)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchmdnet_tpu", "yaml",
             "h5py", "ase", "build_ext", "csrc")
# the readers of HDF5 files and of YAML, each of which may import that
# module inside a function (never at a module's or a class's top level);
# every other port file, and chip_smoke.py, keeps the whole FORBIDDEN list
ALLOWED_IN_FUNCTIONS = {
    ("torchmdnet_tpu_torch/datasets/hdf.py", "h5py"),
    ("torchmdnet_tpu_torch/datasets/ani.py", "h5py"),
    ("torchmdnet_tpu_torch/datasets/spice.py", "h5py"),
    ("torchmdnet_tpu_torch/datasets/ace.py", "h5py"),
    ("torchmdnet_tpu_torch/utils/io.py", "h5py"),
    ("torchmdnet_tpu_torch/datasets/comp6.py", "h5py"),
    ("torchmdnet_tpu_torch/datasets/qm9q.py", "h5py"),
    ("torchmdnet_tpu_torch/datasets/mdcath.py", "h5py"),
    ("torchmdnet_tpu_torch/utils/config.py", "yaml"),
    ("torchmdnet_tpu_torch/md/calculators.py", "ase"),
}
# the JAX package's modules with no module of the same path in the port:
# its download helper (the port downloads nothing), the Pallas kernels
# (ported as csrc/ and the ops that launch them), its JAX tooling
# (chip_smoke.py times and profiles the port) and its checkpoint
# converter (the port's utils/checkpoint.py and utils/jax_params.py)
NOT_TO_PORT = {
    "datasets/_download.py",
    "ops/pallas_blocked_mp.py", "ops/pallas_cheb.py",
    "ops/pallas_coulomb.py", "ops/pallas_embedding.py",
    "ops/pallas_kernels.py",
    "utils/compile_cache.py", "utils/profiling.py",
    "utils/torch_ckpt.py",
}


def _port_files():
    """The port, its card check and its phase probes (they run on the
    card's machine too)."""
    files = sorted((ROOT / "torchmdnet_tpu_torch").rglob("*.py"))
    probes = sorted((ROOT / "tools").glob("torch_*_phases.py"))
    return files + probes + [ROOT / "chip_smoke.py"]


def _imports(path):
    """``(module, inside a function)`` of every import in ``path``, lazy
    ones and ``__import__``/``import_module`` calls too."""
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            in_function.update(id(n) for n in ast.walk(node) if n is not node)
    for node in ast.walk(tree):
        inside = id(node) in in_function
        if isinstance(node, ast.Import):
            yield from ((a.name, inside) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, inside
        elif isinstance(node, ast.Call) and (
                getattr(node.func, "id", None) == "__import__"
                or getattr(node.func, "attr", None) == "import_module"):
            yield from ((a.value, inside) for a in node.args
                        if isinstance(a, ast.Constant))


def _imported_modules(path):
    return [m for m, _ in _imports(path)]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = []
    for f in files:
        name = str(f.relative_to(ROOT))
        for module, inside in _imports(f):
            top = module.split(".")[0]
            if top in FORBIDDEN and not (
                    inside and (name, top) in ALLOWED_IN_FUNCTIONS):
                bad.append((name, module, "in a function" if inside
                            else "at the top level"))
    assert not bad, bad


def test_yaml_and_h5py_only_where_allowed():
    """Each allowed reader really imports its module, inside a function
    only; the data files and the CLI are among the files walked, and
    chip_smoke.py gets no exception."""
    files = {str(f.relative_to(ROOT)): f for f in _port_files()}
    for name, module in ALLOWED_IN_FUNCTIONS:
        found = [inside for m, inside in _imports(files[name])
                 if m.split(".")[0] == module]
        assert found and all(found), (name, module, found)
    for name in ("torchmdnet_tpu_torch/datasets/md17.py",
                 "torchmdnet_tpu_torch/datasets/qm9.py",
                 "torchmdnet_tpu_torch/datasets/maceoff.py",
                 "torchmdnet_tpu_torch/datasets/memdataset.py",
                 "torchmdnet_tpu_torch/data/_native.py",
                 "torchmdnet_tpu_torch/data/collate.py",
                 "torchmdnet_tpu_torch/train/train.py", "chip_smoke.py"):
        assert name in files
    assert not any(name.startswith("chip_smoke")
                   for name, _ in ALLOWED_IN_FUNCTIONS)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(SMALL_ARGS)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(SMALL_ARGS, device="cuda")
    pot = create_model(SMALL_ARGS, device="cpu")
    assert pot.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in pot.module.parameters())
    z = np.ones(8, np.int64)
    init, _, _ = make_md_step(pot, z, np.zeros(8), np.ones(8), dt=0.5,
                              box=np.eye(3, dtype=np.float32) * 12.0)
    pos = np.random.RandomState(0).uniform(0, 12, (8, 3))
    assert init(pos).pos.device.type == "cpu"
    box = np.eye(3, dtype=np.float32) * 12.0
    st = run_md(pot, z, pos, np.ones(8), n_steps=1, dt=0.5, box=box,
                rebuild_every=1)
    assert st.pos.device.type == "cpu"
    # the priors through create_model, and the adaptive blocked MD
    priors = dict(SMALL_ARGS, prior_model=["ZBL", "Atomref"],
                  prior_args=[{"atomic_number": list(range(10))},
                              {"max_z": 10}])
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(priors)
    assert create_model(priors, device="cpu").device == torch.device("cpu")
    spec = make_cell_block_spec([12.0] * 3, 5.5, 8, cap=8)
    pot = create_model(dict(SMALL_ARGS, cell_block_spec=spec), device="cpu")
    init, _, _ = make_adaptive_md_step(pot, z, np.zeros(8), np.ones(8),
                                       dt=0.5, box=box, cell_block_spec=spec)
    assert init(pos).force.device.type == "cpu"


def test_blocked_md_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L = 20.0
    pos = np.random.RandomState(1).uniform(0, L, (12, 3))
    spec = make_cell_block_spec([L] * 3, 5.5, 12, cap=8)
    args = dict(SMALL_ARGS, cell_block_spec=spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(args)
    pot = create_model(args, device="cpu")
    init, chunk, _ = make_md_step(
        pot, np.ones(12, np.int64), np.zeros(12), np.ones(12), dt=0.5,
        box=np.eye(3, dtype=np.float32) * L, cell_block_spec=spec,
        coulomb_window_spec="auto", rebuild_every=1)
    st = chunk(init(pos))
    assert st.pos.device.type == "cpu" and st.cwin is not None
    assert st.cwin.a1.device.type == "cpu" and torch.isfinite(st.force).all()


def test_tf32_is_off_after_create_model():
    """From the start setting ("highest"), ``create_model`` without
    ``matmul_precision`` and with ``"high"`` leaves TF32 off (the flags
    for every name: ``test_torch_precision.py``)."""
    set_matmul_precision("highest")
    create_model(SMALL_ARGS, device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    create_model(dict(SMALL_ARGS, matmul_precision="high"), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_every_jax_module_has_a_counterpart():
    """A JAX module left out of the port (and off :data:`NOT_TO_PORT`)
    fails here; so does a stale entry of the list."""
    jax_pkg, port = ROOT / "torchmdnet_tpu", ROOT / "torchmdnet_tpu_torch"
    jax_files = {str(f.relative_to(jax_pkg))
                 for f in jax_pkg.rglob("*.py")}
    port_files = {str(f.relative_to(port)) for f in port.rglob("*.py")}
    assert NOT_TO_PORT <= jax_files
    assert sorted(jax_files - port_files - NOT_TO_PORT) == []
    assert not NOT_TO_PORT & port_files


def test_adapters_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """``External``, ``TMDNETCalculator`` (under a stand-in ``ase``),
    ``optimize``, ``export_potential``/``load_exported`` and the
    data-parallel step: a checkpoint is read onto the card unless the CPU
    is asked for, a CUDA graph is refused or not taken off the card, and a
    potential on the CPU serves there."""
    import sys
    import types

    from torchmdnet_tpu_torch.md.calculators import (
        External, TMDNETCalculator)
    from torchmdnet_tpu_torch.optimize import optimize
    from torchmdnet_tpu_torch.parallel.dp import (
        make_data_parallel_train_step)
    from torchmdnet_tpu_torch.utils.checkpoint import save_checkpoint
    from torchmdnet_tpu_torch.utils.export import (
        export_potential, load_exported)

    args = dict(TENSORNET_ARGS, embedding_dimension=8, num_layers=1,
                num_rbf=8, max_num_neighbors=8)
    pot = create_model(args, device="cpu")
    ckpt = save_checkpoint(tmp_path / "m.ckpt", pot, hparams=args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.array([1, 6, 8, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        External(ckpt, z)
    ext = External(ckpt, z, device="cpu")
    pos = np.random.RandomState(0).uniform(-1.5, 1.5, (4, 3))
    e, f = ext.calculate(pos)
    assert e.device.type == f.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA"):
        External(pot, z, use_cuda_graph=True)
    calc = types.ModuleType("ase.calculators.calculator")
    calc.Calculator, calc.all_changes = object, []
    monkeypatch.setitem(sys.modules, "ase.calculators.calculator", calc)
    with pytest.raises(RuntimeError, match="CUDA"):
        TMDNETCalculator(ckpt)
    assert TMDNETCalculator(ckpt, device="cpu").potential.device.type == \
        "cpu"
    for kw in ({}, {"rebuild_every": 2, "skin": 0.5}):
        step = optimize(pot, z, np.zeros(4), num_mols=1, **kw)
        assert step(pos)[0].device.type == "cpu"
        assert not step.runner.graphed  # a CUDA graph on the card only
    run = load_exported(export_potential(pot, z, np.zeros(4), num_mols=1))
    assert run(torch.as_tensor(pos, dtype=torch.float32))[1].device.type \
        == "cpu"
    assert callable(make_data_parallel_train_step(pot, num_mols=1))
