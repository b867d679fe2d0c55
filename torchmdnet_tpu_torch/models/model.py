"""Model composition: ``TorchMDNet``, ``Potential``, ``create_model``,
checkpoint loading and ensembles.

Counterpart of ``torchmdnet_tpu/models/model.py`` (``TorchMDNet``
``:26-111``, ``Potential``, ``create_prior_models``, ``create_model``,
``load_model``, ``Ensemble``, ``load_ensemble``) for every representation
of the JAX package (``REPRESENTATIONS``) with every head of
``OUTPUT_MODULES``, each with any of the priors (``priors/``) and
``atom_filter``.  Forces are ``−∂Σy/∂pos`` from ``torch.autograd.grad``.
``create_model`` takes the JAX package's args dict as it is.
"""

import copy
import glob
import os
import tempfile
import zipfile

import numpy as np
import torch
from torch import nn

from torchmdnet_tpu_torch import priors as priors_pkg
from torchmdnet_tpu_torch.models.common import reset_parameters
from torchmdnet_tpu_torch.models.output_modules import OUTPUT_MODULES
from torchmdnet_tpu_torch.models.tensornet import TensorNet
from torchmdnet_tpu_torch.models.tensornet2 import TensorNet2
from torchmdnet_tpu_torch.models.torchmd_et import TorchMD_ET
from torchmdnet_tpu_torch.models.torchmd_gn import TorchMD_GN
from torchmdnet_tpu_torch.models.torchmd_t import TorchMD_T
from torchmdnet_tpu_torch.ops.cell_blocks import CellBlockSpec
from torchmdnet_tpu_torch.ops.config import resolve_device, set_matmul_precision


class TorchMDNet(nn.Module):
    """representation → atom filter → output.pre_reduce → ×std → priors'
    pre_reduce → reduce → +mean → output.post_reduce → priors' post_reduce
    (reference ``model.py:530-631``, JAX ``:76-110``); returns
    ``y [num_mols, out]``.

    ``atom_filter`` > -1 drops the atoms with ``Z ≤ atom_filter`` after the
    representation (reference ``wrappers.py:33-67``): as in JAX, their
    features are zeroed rather than their rows removed.  ``mean`` and
    ``std`` are plain floats, outside the state dict; a checkpoint carries
    them as ``model.mean``/``model.std`` (``utils/checkpoint.py``)."""

    def __init__(self, representation_model, output_model, prior_models=(),
                 mean=0.0, std=1.0, atom_filter=-1):
        super().__init__()
        self.representation_model = representation_model
        self.output_model = output_model
        # upstream's attribute name: keys ``prior_model.<i>.…``
        self.prior_model = nn.ModuleList(prior_models)
        self.mean = float(mean)
        self.std = float(std)
        self.atom_filter = int(atom_filter)

    def forward(self, z, pos, batch, *, num_mols: int, box=None, q=None,
                extra_args=None, nbr=None, coulomb_nbr=None, blocked=False,
                coulomb_win=None, nbr_emb=None):
        """``blocked``: the rows are in a cell-blocked sort
        (``ops/cell_blocks.py``) and the model was built with a
        ``cell_block_spec``, so the interactions run the blocked tier (the
        q-tier on TensorNet2, rows 8-11 on TensorNet);
        ``coulomb_win``: the windows of the windowed Coulomb head;
        ``nbr_emb`` (TensorNet2 on a grouped spec): the compact list of the
        dual-list embedding; ``extra_args``: what the priors read (the
        Coulomb prior's ``partial_charges``)."""
        atom_mask = batch < num_mols
        rep_kwargs = {} if nbr_emb is None else {"nbr_emb": nbr_emb}
        x, v = self.representation_model(z, pos, batch, box=box, q=q,
                                          atom_mask=atom_mask, nbr=nbr,
                                          num_mols=num_mols, blocked=blocked,
                                          **rep_kwargs)
        # the head (output MLP, priors, reductions) runs in ≥ float32 when
        # the representation computes in bfloat16 (JAX :77-82)
        if x.dtype == torch.bfloat16:
            x = x.float()
        if v is not None and v.dtype == torch.bfloat16:
            v = v.float()
        if self.atom_filter > -1:
            keep = (z > self.atom_filter)[:, None].to(x.dtype)
            x = x * keep
            if v is not None:
                v = v * keep[:, :, None]
        x = self.output_model.pre_reduce(x, v, z, pos, batch, box=box,
                                         num_mols=num_mols, nbr=coulomb_nbr,
                                         win=coulomb_win)
        x = x * self.std
        for prior in self.prior_model:
            x = prior.pre_reduce(x, z, pos, batch, extra_args, num_mols)
        y = self.output_model.reduce(x, batch, num_mols) + self.mean
        y = self.output_model.post_reduce(y)
        for prior in self.prior_model:
            y = prior.post_reduce(y, z, pos, batch, box, extra_args, num_mols)
        return y


class Potential:
    """(energy, forces) around a :class:`TorchMDNet` whose weights live on
    ``device``.  Inputs may be tensors or arrays; they are moved there."""

    def __init__(self, module: TorchMDNet, device: torch.device,
                 derivative: bool = True, hparams=None,
                 dtype=torch.float32):
        self.module = module
        self.device = device
        self.derivative = derivative
        self.hparams = dict(hparams or {})
        # the dtype positions and boxes come in as (float64 under
        # precision=64)
        self.dtype = dtype

    def with_spec(self, spec) -> "Potential":
        """The same model and weights on another ``cell_block_spec`` (None:
        the gather path); the spec is baked into the model, so it is
        rebuilt from ``hparams`` as the JAX package's adaptive MD does."""
        m = self.module
        pot = create_model(dict(self.hparams, cell_block_spec=spec),
                           prior_models=copy.deepcopy(list(m.prior_model)),
                           mean=m.mean, std=m.std, device=self.device,
                           rbf_initial=m.representation_model
                           .distance_expansion.values())
        pot.module.load_state_dict(m.state_dict())
        return pot

    def _inputs(self, z, pos, batch, box):
        dev = self.device
        z = torch.as_tensor(z, device=dev).long()
        pos = torch.as_tensor(pos, dtype=self.dtype, device=dev)
        if batch is None:
            batch = torch.zeros(z.shape[0], dtype=torch.long, device=dev)
        batch = torch.as_tensor(batch, device=dev).long()
        if box is not None:
            box = torch.as_tensor(box, dtype=self.dtype, device=dev)
        return z, pos, batch, box

    def energy(self, z, pos, batch=None, *, num_mols: int = 1, box=None,
               q=None, extra_args=None, nbr=None, coulomb_nbr=None,
               blocked=False, coulomb_win=None, nbr_emb=None):
        """Per-molecule energies ``y [num_mols, 1]``."""
        z, pos, batch, box = self._inputs(z, pos, batch, box)
        return self.module(z, pos, batch, num_mols=num_mols, box=box, q=q,
                           extra_args=extra_args, nbr=nbr,
                           coulomb_nbr=coulomb_nbr, blocked=blocked,
                           coulomb_win=coulomb_win, nbr_emb=nbr_emb)

    def apply(self, z, pos, batch=None, *, num_mols: int = 1, box=None,
              q=None, extra_args=None, nbr=None, coulomb_nbr=None,
              blocked=False, coulomb_win=None, nbr_emb=None,
              create_graph=False):
        """``(y, −∂Σy/∂pos)``; the second item is None unless the model was
        built with ``derivative``.

        ``create_graph`` (training): both stay attached to the graph —
        the forces through ``torch.autograd.grad(..., create_graph=True)``
        — so that a loss on them reaches the parameters (the reference's
        force training, JAX ``jax.grad`` inside the loss)."""
        z, pos, batch, box = self._inputs(z, pos, batch, box)
        kw = dict(num_mols=num_mols, box=box, q=q, extra_args=extra_args,
                  nbr=nbr, coulomb_nbr=coulomb_nbr, blocked=blocked,
                  coulomb_win=coulomb_win, nbr_emb=nbr_emb)
        if not self.derivative:
            with torch.set_grad_enabled(create_graph):
                return self.module(z, pos, batch, **kw), None
        pos = pos.detach().requires_grad_(True)
        with torch.enable_grad():
            y = self.module(z, pos, batch, **kw)
            (dy,) = torch.autograd.grad(y.sum(), pos,
                                        create_graph=create_graph)
        if create_graph:
            return y, -dy
        return y.detach(), -dy


REPRESENTATIONS = ("tensornet", "tensornet2", "equivariant-transformer",
                   "transformer", "graph-network")


def _check_supported(args: dict) -> None:
    if args["model"] not in REPRESENTATIONS:
        raise ValueError(f"Unknown architecture: {args['model']}")
    if int(args.get("precision", 32)) not in (16, 32, 64):
        raise ValueError(f"precision={args['precision']}: choose 16, 32 "
                         "or 64")


def prior_specs(args: dict) -> list:
    """``[(name, arguments), …]`` of ``args["prior_model"]``: a name, a
    list of names, or dicts of name → arguments, with
    ``args["prior_args"]`` in place of those arguments when given."""
    if not args.get("prior_model"):
        return []
    prior_model = args["prior_model"]
    if not isinstance(prior_model, (list, tuple)):
        prior_model = [prior_model]
    names, prior_args = [], []
    for prior in prior_model:
        if isinstance(prior, dict):
            for key, value in prior.items():
                names.append(key)
                prior_args.append(value or {})
        else:
            names.append(prior)
            prior_args.append({})
    if args.get("prior_args") is not None:
        prior_args = args["prior_args"]
        if not isinstance(prior_args, (list, tuple)):
            prior_args = [prior_args]
    return list(zip(names, prior_args))


def create_prior_models(args: dict, dataset=None) -> tuple:
    """The priors of ``args["prior_model"]``: a name, a list of names, or
    dicts of name → arguments, with ``args["prior_args"]`` in place of
    those arguments when given (reference ``model.py:377-448``, JAX
    ``:166-214``).  A ``dataset`` supplies the element map, the unit
    scales and the atomref table the arguments leave out."""
    out = []
    for name, arg in prior_specs(args):
        if name not in priors_pkg.PRIOR_CLASSES:
            raise ValueError(f"Unknown prior model {name}. Available: "
                             f"{', '.join(priors_pkg.__all__)}")
        arg = dict(arg)
        if dataset is not None:
            # priors take element maps and unit scales from the dataset
            # (reference scripts/train.py:198-199, zbl.py:45-50)
            if name in ("ZBL", "Coulomb", "D2"):
                arg.setdefault("distance_scale", float(dataset.distance_scale))
                arg.setdefault("energy_scale", float(dataset.energy_scale))
            if name in ("ZBL", "D2") and "atomic_number" not in arg:
                arg["atomic_number"] = tuple(
                    int(v) for v in np.asarray(dataset.atomic_number).tolist())
            if name in ("Atomref", "LearnableAtomref"):
                atomref = getattr(dataset, "get_atomref", lambda: None)()
                if atomref is not None:
                    arg.setdefault("initial_atomref", np.asarray(atomref))
                else:
                    arg.setdefault("max_z", 100)
        out.append(priors_pkg.PRIOR_CLASSES[name](**arg))
    return tuple(out)


def _make_representation(args: dict, output_model: str, rbf_initial,
                         dtype):
    """The representation model of ``args["model"]`` with JAX
    ``_make_representation``'s arguments (``models/model.py:218-298``)."""
    model = args["model"]
    cpd = args.get("cells_per_dim")
    shared = dict(
        hidden_channels=args["embedding_dimension"],
        num_layers=args["num_layers"],
        num_rbf=args["num_rbf"],
        rbf_type=args["rbf_type"],
        trainable_rbf=args["trainable_rbf"],
        rbf_initial=rbf_initial,
        activation=args["activation"],
        cutoff_lower=float(args["cutoff_lower"]),
        cutoff_upper=float(args["cutoff_upper"]),
        max_num_neighbors=args["max_num_neighbors"],
        max_z=args["max_z"],
        neighbor_strategy=args.get("neighbor_strategy", "brute"),
        cells_per_dim=tuple(int(c) for c in cpd) if cpd else None,
        cell_capacity=int(args.get("cell_capacity", 64)),
        dtype=dtype)
    if model in ("tensornet", "tensornet2"):
        spec = args.get("cell_block_spec")
        shared.update(
            equivariance_invariance_group=args[
                "equivariance_invariance_group"],
            pallas_edge_mlp=bool(args.get("pallas_edge_mlp", False)),
            pallas_embedding=bool(args.get("pallas_embedding", False)),
            remat=bool(args.get("remat", False)),
            cell_block_spec=(None if spec is None
                             else CellBlockSpec(**spec._asdict())))
    if model == "tensornet":
        return TensorNet(
            tabulated_edge_mlp=int(args.get("tabulated_edge_mlp", 0)),
            **shared)
    if model == "tensornet2":
        return TensorNet2(
            q_dim=args.get("q_dim", 0),
            output_charges="Coul" in output_model,
            q_tab=int(args.get("q_tab", 64)), **shared)
    if model == "graph-network":
        return TorchMD_GN(num_filters=args["embedding_dimension"],
                          aggr=args["aggr"],
                          neighbor_embedding=args["neighbor_embedding"],
                          **shared)
    attention = dict(attn_activation=args["attn_activation"],
                     num_heads=args["num_heads"],
                     distance_influence=args["distance_influence"],
                     neighbor_embedding=args["neighbor_embedding"])
    if model == "transformer":
        return TorchMD_T(**attention, **shared)
    return TorchMD_ET(vector_cutoff=bool(args.get("vector_cutoff", False)),
                      **attention, **shared)


def create_model(args: dict, prior_models=None, mean=None, std=None,
                 device=None, seed: int = 0, rbf_initial=None) -> Potential:
    """Build a :class:`Potential` from a reference-compatible args dict
    (reference ``model.py:21-164``, JAX ``:301-375``).

    ``prior_models`` defaults to :func:`create_prior_models` of ``args``;
    ``mean`` and ``std`` (a dataset's, ``DataModule.mean``/``std``) shift
    and scale the prediction, 0 and 1 when not given.  A head with
    ``allow_prior_model = False`` (the dipole and spatial-extent heads)
    drops the priors, as JAX does.  ``rbf_initial``: the frozen rbf
    buffers of a checkpoint (``load_model`` passes them).

    Weights are drawn from a ``torch.Generator`` seeded with ``seed`` and
    frozen (``requires_grad=False``), as inference and MD want them;
    training turns their gradients on (``train/step.py::
    create_train_state``).  ``device`` defaults to CUDA and raises when
    CUDA is absent.
    ``args["matmul_precision"]``, when given, sets the global float32
    matmul precision (``ops/config.py``), as the JAX package does; without
    it the setting stays as it was (full float32 unless changed).

    ``args["precision"]`` (JAX ``models/model.py:220-223``): 32, the
    default; 64 computes in float64 (the weights and the inputs:
    ``Potential`` takes positions as float64, as upstream's Lightning
    precision 64 and JAX's x64 mode keep the input dtype); 16 computes the
    representation's layers in bfloat16 with float32 weights, layer by
    layer as JAX's ``Linear(dtype=bfloat16)`` does (no autocast).  The
    kernels take float32 only, so under 16 or 64 the fused branches take
    the plain chain, where JAX's do.  ``args["remat"]``: selective
    recomputation of the representation's layers in the backward
    (``models/tensornet.py::remat_call``; TensorNet and TensorNet2 only,
    as in JAX, which also reads ``equivariance_invariance_group``, the
    kernels' flags and ``cell_block_spec`` for those two alone).
    """
    device = resolve_device(device)
    args = dict(args)
    _check_supported(args)
    if args.get("matmul_precision"):
        set_matmul_precision(args["matmul_precision"])
    model = args["model"]
    output_model = args.get("output_model", "Scalar")
    # JAX's naming rule (models/model.py:329-331): on the equivariant
    # representation every head is the Equivariant one of that name
    head_name = ("Equivariant" + output_model
                 if model == "equivariant-transformer" else output_model)
    if head_name not in OUTPUT_MODULES:
        raise ValueError(f"Unknown output model {head_name!r}. Choose "
                         f"from {', '.join(OUTPUT_MODULES)}.")
    head_cls = OUTPUT_MODULES[head_name]
    if head_cls.needs_vectors and model != "equivariant-transformer":
        # JAX builds it and fails at the first evaluation (v is None)
        raise ValueError(
            f"output_model={output_model!r} reads vector features, which "
            f"model={model!r} does not produce: on the equivariant "
            "representation (model='equivariant-transformer') every head "
            "reads them, named without the 'Equivariant' prefix")
    if head_name == "ScalarPlusWeightedCoulomb" and model != "tensornet2":
        raise ValueError("ScalarPlusWeightedCoulomb reads the per-layer "
                         "charges that only model='tensornet2' appends")
    precision = int(args.get("precision", 32))
    atom_filter = int(args.get("atom_filter", -1))
    if args.get("derivative", False) and atom_filter > -1:
        raise ValueError("Derivative and atom filter can't be used together")
    F = args["embedding_dimension"]
    rep = _make_representation(args, output_model, rbf_initial,
                               dtype=torch.bfloat16 if precision == 16
                               else None)
    head_kwargs = dict(hidden_channels=F, activation=args["activation"],
                       reduce_op=args.get("reduce_op", "sum"))
    if head_name == "ScalarPlusWeightedCoulomb":
        ccpd = args.get("coulomb_cells_per_dim")
        head = head_cls(
            num_hidden_layers=args.get("output_mlp_num_layers", 0),
            q_dim=args.get("q_dim", 0),
            num_interaction_layers=args["num_layers"],
            q_weights=tuple(tuple(w) if isinstance(w, (list, tuple)) else (w,)
                            for w in args.get("q_weights", [])),
            coulomb_cutoff=args.get("coulomb_cutoff"),
            coulomb_max_num_neighbors=args.get("coulomb_max_num_neighbors"),
            coulomb_neighbor_strategy=args.get("coulomb_neighbor_strategy",
                                               "brute"),
            coulomb_cells_per_dim=(tuple(int(c) for c in ccpd)
                                   if ccpd else None),
            coulomb_cell_stencil=int(args.get("coulomb_cell_stencil", 1) or 1),
            coulomb_cell_capacity=int(args.get("coulomb_cell_capacity", 64)
                                      or 64),
            **head_kwargs)
    else:
        # reference quirk (upstream create_model): the head's MLP depth is 0
        head = head_cls(num_hidden_layers=0, **head_kwargs)
    if args.get("prior_model") and prior_models is None:
        prior_models = create_prior_models(args)
    if not head.allow_prior_model:
        prior_models = ()
    module = TorchMDNet(rep, head, prior_models=tuple(prior_models or ()),
                        mean=0.0 if mean is None else mean,
                        std=1.0 if std is None else std,
                        atom_filter=atom_filter)
    reset_parameters(module, torch.Generator().manual_seed(int(seed)))
    module.requires_grad_(False)
    dtype = torch.float64 if precision == 64 else torch.float32
    return Potential(module.to(device=device, dtype=dtype), device,
                     derivative=bool(args.get("derivative", False)),
                     hparams=args, dtype=dtype)


def load_model(filepath, args=None, device=None, return_std=False,
               **kwargs):
    """A :class:`Potential` from a reference Lightning ``.ckpt`` (upstream
    torchmd-net's, the JAX package's ``save_torch_checkpoint``'s or this
    port's), or an :class:`Ensemble` from a list of them or a ``.zip``
    (reference ``model.py:167-374``, JAX ``:380-395``).

    ``kwargs`` override the checkpoint's hyperparameters (for example
    ``derivative=True, pallas_embedding=True, pallas_edge_mlp=True``);
    ``compatibility_load`` forces or skips the old AceFF layout remap;
    ``remove_ref_energy=False`` re-enables a delta-learning Atomref.
    ``device`` defaults to CUDA and raises when CUDA is absent.  The file
    is unpickled (its hyperparameters are Python objects): load trusted
    files only.  See ``utils/checkpoint.py::load_checkpoint_as_potential``.
    """
    if isinstance(filepath, (list, tuple)) or str(filepath).endswith(".zip"):
        return load_ensemble(filepath, args=args, device=device,
                             return_std=return_std, **kwargs)
    from torchmdnet_tpu_torch.utils.checkpoint import (
        load_checkpoint_as_potential)
    return load_checkpoint_as_potential(filepath, args=args, device=device,
                                        **kwargs)


class Ensemble:
    """The mean of several potentials' predictions, and with
    ``return_std`` their ``ddof = 1`` standard deviation (reference
    ``model.py:634-681``, JAX ``:398-423``); with one member the std is
    NaN, as in both."""

    def __init__(self, members, return_std=False):
        self.members = list(members)
        self.return_std = return_std

    def apply(self, z, pos, batch=None, **kw):
        """``(y_mean, f_mean)``, or ``(y_mean, f_mean, y_std, f_std)``;
        the forces are None when the members have no ``derivative``."""
        ys, fs = zip(*(pot.apply(z, pos, batch, **kw)
                       for pot in self.members))
        y = torch.stack(ys)
        y_mean, y_std = y.mean(dim=0), y.std(dim=0, correction=1)
        f_mean = f_std = None
        if fs[0] is not None:
            f = torch.stack(fs)
            f_mean, f_std = f.mean(dim=0), f.std(dim=0, correction=1)
        if self.return_std:
            return y_mean, f_mean, y_std, f_std
        return y_mean, f_mean


def load_ensemble(filepath, args=None, device=None, return_std=False,
                  **kwargs):
    """An :class:`Ensemble` of a list of checkpoints or of every ``*.ckpt``
    in a ``.zip`` (reference ``model.py:167-205``, JAX ``:426-445``)."""
    if isinstance(filepath, (list, tuple)):
        return Ensemble([load_model(p, args=args, device=device, **kwargs)
                         for p in filepath], return_std=return_std)
    if str(filepath).endswith(".zip"):
        with tempfile.TemporaryDirectory() as tmpdir:
            with zipfile.ZipFile(filepath, "r") as zf:
                zf.extractall(tmpdir)
            paths = sorted(glob.glob(os.path.join(tmpdir, "*.ckpt")))
            if not paths:
                raise ValueError("No checkpoint files found in zip file.")
            members = [load_model(p, args=args, device=device, **kwargs)
                       for p in paths]
        return Ensemble(members, return_std=return_std)
    raise ValueError("Invalid filepath for ensemble.")
