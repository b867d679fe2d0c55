"""Inference adapters (counterpart of ``torchmdnet_tpu/md/calculators.py``,
reference ``torchmdnet/calculators.py``).

* :class:`External`: the TorchMD calculator,
  ``calculate(pos, box) -> (E [B], F [B, n, 3])`` for B replicas of one
  system.  By default each call is an eager evaluation; with
  ``use_cuda_graph=True`` (on the card) the first call of each mode (with
  or without a box) captures the evaluation into a CUDA graph after
  ``cuda_graph_warmup_steps`` warm-up calls (``utils/graphs.py``), and
  every later call copies its positions (and box) into the graph's static
  buffers and replays it (reference ``calculators.py:117-169``; the JAX
  package's jitted step).
* :class:`TMDNETCalculator`: the ASE calculator; the charge from
  ``atoms.info["charge"]`` (0 if absent), the box from ``atoms.cell`` when
  ``atoms.pbc`` has a periodic axis; ``ase`` is imported when one is built.

Both take a checkpoint path (read by ``load_model(..., derivative=True)``
on ``device``: the card unless ``device="cpu"``) or a
:class:`~torchmdnet_tpu_torch.models.model.Potential`, whose weights stay
where they are.  :data:`transforms` are the reference's unit transforms
(``calculators.py:10-23``).
"""

import numpy as np
import torch

from torchmdnet_tpu_torch.utils.graphs import GraphedStep

transforms = {
    "eV/A -> kcal/mol/A": lambda energy, forces: (
        energy * 23.0609, forces * 23.0609),
    "Hartree/Bohr -> kcal/mol/A": lambda energy, forces: (
        energy * 627.509, forces * 627.509 / 0.529177),
    "Hartree/A -> kcal/mol/A": lambda energy, forces: (
        energy * 627.509, forces * 627.509),
}


def _load(netfile, device=None, **kwargs):
    """A :class:`Potential` with forces: read from a checkpoint path, or
    the one given."""
    if isinstance(netfile, (str, bytes)) or hasattr(netfile, "__fspath__"):
        from torchmdnet_tpu_torch.models.model import load_model

        return load_model(netfile, device=device,
                          **dict(kwargs, derivative=True))
    return netfile


class External:
    """TorchMD adapter: ``calculate(pos, box) -> (E [B], F [B, n, 3])``,
    tensors on the potential's device.

    ``embeddings`` is [B, n] (or [n]) atom types for B replicas; positions
    arrive as [B·n, 3] or [B, n, 3].  ``dtype`` is accepted for the
    reference's signature; the potential's own dtype is used."""

    def __init__(self, netfile, embeddings, device=None,
                 output_transform=None, use_cuda_graph=False,
                 cuda_graph_warmup_steps=12, dtype=None, **kwargs):
        self.potential = _load(netfile, device=device, **kwargs)
        dev = self.device = self.potential.device
        emb = torch.as_tensor(np.asarray(embeddings))
        if emb.dim() == 1:
            emb = emb[None]
        self.n_replicas, self.n_atoms = emb.shape
        self.z = emb.reshape(-1).long().to(dev)
        self.batch = torch.arange(self.n_replicas, device=dev) \
            .repeat_interleave(self.n_atoms)
        if output_transform is None:
            self.output_transformer = lambda e, f: (e, f)
        elif callable(output_transform):
            self.output_transformer = output_transform
        else:
            self.output_transformer = transforms[output_transform]
        if use_cuda_graph and dev.type != "cuda":
            raise ValueError("use_cuda_graph needs the potential on CUDA, "
                             f"not {dev}")
        self.use_cuda_graph = bool(use_cuda_graph)
        self.cuda_graph_warmup_steps = int(cuda_graph_warmup_steps)
        self._graphs = {}  # with a box or not → GraphedStep

    def _step(self, pos, box=None):
        return self.potential.apply(self.z, pos, self.batch,
                                    num_mols=self.n_replicas, box=box)

    def calculate(self, pos, box=None):
        pos = torch.as_tensor(pos, dtype=self.potential.dtype,
                              device=self.device).reshape(-1, 3)
        if box is not None:
            box = torch.as_tensor(box, dtype=self.potential.dtype,
                                  device=self.device)
            if not bool(box.any()):
                box = None
        args = (pos,) if box is None else (pos, box)
        if self.use_cuda_graph:
            key = box is not None
            if key not in self._graphs:
                self._graphs[key] = GraphedStep(
                    self._step, args, self.cuda_graph_warmup_steps)
            y, neg_dy = self._graphs[key](*args)
        else:
            y, neg_dy = self._step(*args)
        energy = y.reshape(self.n_replicas)
        forces = neg_dy.reshape(self.n_replicas, self.n_atoms, 3)
        return self.output_transformer(energy, forces)


class TMDNETCalculator:
    """ASE calculator adapter (reference ``calculators.py:183-320``):
    energies in eV, forces in eV/Å as numpy arrays.  The charge comes from
    ``atoms.info["charge"]`` (0 if absent) and the box from ``atoms.cell``
    when ``atoms.pbc`` has a periodic axis.  The inputs of each atom count
    are cached (the reference compiles a step per count).
    ``remove_ref_energy`` (default True) and ``max_num_neighbors``
    (default 64) go to ``load_model``; ``dtype`` and ``compile`` are
    accepted for the reference's signature."""

    implemented_properties = ["energy", "forces"]

    def __init__(self, model_file, device=None, dtype=None, compile=False,
                 **kwargs):
        try:
            from ase.calculators.calculator import Calculator, all_changes
        except ImportError as exc:
            raise ImportError("ase is required for TMDNETCalculator") \
                from exc
        self._ase_base = Calculator
        self._all_changes = all_changes
        self.results = {}
        self.atoms = None
        self.remove_ref_energy = kwargs.pop("remove_ref_energy", True)
        self.max_num_neighbors = kwargs.pop("max_num_neighbors", 64)
        self.potential = _load(model_file, device=device,
                               remove_ref_energy=self.remove_ref_energy,
                               max_num_neighbors=self.max_num_neighbors,
                               **kwargs)
        self._batches = {}
        self.evals = 0

    def _batch(self, n):
        if n not in self._batches:
            self._batches[n] = torch.zeros(n, dtype=torch.long,
                                           device=self.potential.device)
        return self._batches[n]

    def get_potential_energy(self, atoms, **kw):
        self.calculate(atoms)
        return self.results["energy"]

    def get_forces(self, atoms, **kw):
        self.calculate(atoms)
        return self.results["forces"]

    def calculate(self, atoms=None, properties=None, system_changes=None):
        pot = self.potential
        numbers = torch.as_tensor(np.asarray(atoms.numbers, np.int64),
                                  device=pot.device)
        charge = float(atoms.info.get("charge", 0.0))
        box = None
        if bool(np.asarray(atoms.pbc).any()):
            box = np.asarray(atoms.cell.array, np.float32)
        y, neg_dy = pot.apply(
            numbers, np.asarray(atoms.positions, np.float32),
            self._batch(len(numbers)), num_mols=1, box=box,
            q=torch.tensor([charge], dtype=pot.dtype, device=pot.device))
        self.evals += 1
        self.atoms = atoms
        self.results = {"energy": float(y.reshape(())),
                        "forces": neg_dy.detach().cpu().numpy()}
