"""Lightning checkpoints: write the whole model, read upstream's, the JAX
package's and this port's.

Counterpart of ``torchmdnet_tpu/utils/torch_ckpt.py``.  The port's modules
carry upstream torchmd-net's attribute names, so a checkpoint's state dict
loads with ``load_state_dict`` once the backward-compat remaps of the
reference loader (``torchmdnet/models/model.py:208-374``) have run:

* the ``model.`` prefix stripped;
* upstream's PR#314 MLP key renames (``output_network.{0,1}.update_net.N``
  → ``…update_net.layers.N``; ``output_network.{0,2}`` →
  ``output_network.layers.{0,2}``);
* the JAX package's literal block names of the equivariant heads
  (``output_network_0.`` → ``output_network.0.``);
* TorchMD-GN's second copy of its filter network (``interactions.<i>.
  conv.net.<j>`` → ``interactions.<i>.mlp.<j>``);
* the model aliases ``tensornetv2_alt``/``tensornet-nqe`` → tensornet2;
* the old AceFF ``[N, F, 3, 3]`` layout: ``remix_linear`` of the
  ``linears_scalar`` weights, detected by ``check_errors`` in the
  hyperparameters (``compatibility_load=`` overrides);
* delta learning: ``remove_ref_energy=False`` re-enables a trailing
  Atomref.

Buffers outside the port's state dict come in through the constructors:
the frozen rbf buffers as ``rbf_initial``, a non-trainable Atomref's table
as ``initial_atomref``, ``model.mean``/``model.std`` as ``mean``/``std``.
:func:`save_checkpoint` writes them all, with the key set of JAX's
``save_torch_checkpoint`` (``:247-360``), so that upstream's strict
``load_state_dict`` and JAX's ``load_model`` find every key.
"""

import re
import warnings

import numpy as np
import torch

from torchmdnet_tpu_torch.utils.jax_params import GN_FILTER_ALIAS

CKPT_PREFIX = "model."  # the reference LNNP holds the model as ``model``

# Buffers that carry no learnable state (recomputed or config-derived)
_SKIP_PATTERNS = [
    r"\.initial_atomref$",
    r"(^|\.)mean$",
    r"(^|\.)std$",
    r"\.distance\.box$",
    r"\.box$",
    r"\.Zij_map$",
    r"\.qweights$",
    r"\.atomic_mass$",
    r"\.atomic_number$",
    r"\.C_6$",
    r"\.R_r$",
    r"\.Z_map$",
    r"\.edge_index$",
]

# Structural aliases between a file's names and the port's layout.  The
# JAX package writes the equivariant heads' blocks under their literal
# flax names (its ``_flax_path_to_torch_key`` keeps ``output_network_0``);
# upstream's ``ModuleList`` and the port write ``output_network.0``.
# TorchMD-GN's filter network is one module that upstream registers twice,
# as ``interactions.<i>.mlp`` and as its CFConv's ``conv.net``, so its
# files hold both copies; the port and JAX's files hold ``mlp`` alone
# (JAX maps it onto its flax ``conv/net`` on load, ``torch_ckpt.py:48-50``).
_ALIAS_PATTERNS = [
    (r"^output_model\.output_network_(\d+)\.", r"output_model.output_network.\1."),
    (GN_FILTER_ALIAS[0].pattern, GN_FILTER_ALIAS[1]),
]

_PR314_PATTERNS = [
    (
        r"output_model.output_network.(\d+).update_net.(\d+)\.",
        r"output_model.output_network.\1.update_net.layers.\2.",
    ),
    (
        r"output_model.output_network.([02]).(weight|bias)",
        r"output_model.output_network.layers.\1.\2",
    ),
]

# the frozen rbf buffers (non-persistent in the port's smearings)
RBF_BUFFERS = ("means", "betas", "offset", "coeff")
_RBF_PREFIX = "representation_model.distance_expansion."


def is_skipped(key: str) -> bool:
    return any(re.search(p, key) for p in _SKIP_PATTERNS)


def _cpu(t):
    return t.detach().cpu().clone()


def save_checkpoint(path, potential, hparams=None, mean=None, std=None):
    """Write ``potential`` (a ``Potential`` or its ``TorchMDNet``) as a
    Lightning checkpoint ``{"state_dict", "hyper_parameters"}``: the
    ``model.``-prefixed state dict, the buffers upstream keeps (the rbf
    means and betas or offset and coeff, the priors' tables, the zero
    ``distance.box`` buffers), ``model.mean`` and ``model.std`` (``mean``
    and ``std`` override the model's), and the hyperparameters
    (``hparams``, else the potential's)."""
    module = getattr(potential, "module", potential)
    if hparams is None:
        hparams = getattr(potential, "hparams", {})
    sd = {CKPT_PREFIX + k: _cpu(v) for k, v in module.state_dict().items()}
    pfx = CKPT_PREFIX + _RBF_PREFIX
    for name, buf in module.representation_model.distance_expansion \
            .named_buffers():
        sd.setdefault(pfx + name, _cpu(buf))
    sd.setdefault(CKPT_PREFIX + "representation_model.distance.box",
                  torch.zeros(3, 3))
    if getattr(module.output_model, "coulomb_cutoff", None):
        sd.setdefault(CKPT_PREFIX + "output_model.distance.box",
                      torch.zeros(3, 3))
    from torchmdnet_tpu_torch.priors import D2, ZBL, Atomref, Coulomb

    for i, prior in enumerate(module.prior_model):
        p = f"{CKPT_PREFIX}prior_model.{i}"
        if isinstance(prior, Atomref):
            sd.setdefault(f"{p}.atomref.weight", _cpu(prior._table()))
            sd[f"{p}.initial_atomref"] = _cpu(prior.initial_atomref)
        elif isinstance(prior, ZBL):
            sd[f"{p}.atomic_number"] = torch.tensor(
                list(prior.atomic_number), dtype=torch.long)
            sd[f"{p}.distance.box"] = torch.zeros(3, 3)
        elif isinstance(prior, D2):
            sd[f"{p}.Z_map"] = torch.tensor(list(prior.atomic_number),
                                            dtype=torch.long)
            sd[f"{p}.C_6"] = _cpu(prior.c6)
            sd[f"{p}.R_r"] = _cpu(prior.rr)
            sd[f"{p}.distances.box"] = torch.zeros(3, 3)
        elif isinstance(prior, Coulomb):
            sd[f"{p}.distance.box"] = torch.zeros(3, 3)
    sd[CKPT_PREFIX + "mean"] = torch.tensor(
        float(module.mean if mean is None else mean))
    sd[CKPT_PREFIX + "std"] = torch.tensor(
        float(module.std if std is None else std))
    torch.save({"state_dict": sd, "hyper_parameters": dict(hparams)}, path)
    return path


def read_torch_checkpoint(path):
    """``(hyper_parameters, state dict of CPU tensors)`` of a Lightning
    checkpoint or a bare state dict.  Unpickles the file
    (``weights_only=False``: upstream's hyperparameters are Python
    objects, which PyTorch's default refuses), so read trusted files
    only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    hparams = dict(ckpt.get("hyper_parameters", {}))
    raw = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return hparams, {k: v.detach().cpu() if isinstance(v, torch.Tensor)
                     else torch.as_tensor(np.asarray(v))
                     for k, v in raw.items()}


def remix_linear(weight, bias):
    """The old ``[N, F, 3, 3]`` → ``[N, 3, 3, F]`` layout reshuffle of a
    linear layer's rows (reference ``model.py:321-331``)."""
    a, b = weight.shape
    w = weight.reshape(a // 3, 3, b).permute(1, 0, 2).reshape(a, b)
    bb = bias.reshape(a // 3, 3).T.reshape(a)
    return w.contiguous(), bb.contiguous()


def rename_keys(state_dict):
    """The ``model.`` prefix stripped, upstream's PR#314 renames and the
    JAX package's literal names mapped onto the port's keys."""
    sd = {re.sub(r"^model\.", "", k): v for k, v in state_dict.items()}
    for pat, repl in _PR314_PATTERNS + _ALIAS_PATTERNS:
        sd = {re.sub(pat, repl, k): v for k, v in sd.items()}
    return sd


def apply_reference_compat(state_dict, args: dict, hparams: dict,
                           kwargs: dict):
    """Key renames and old-layout remixes (reference ``model.py:261-373``,
    JAX ``torch_ckpt.py:88-114``) → a state dict in the port's names."""
    sd = rename_keys(state_dict)
    is_old_format = "check_errors" in hparams
    if kwargs.get("compatibility_load", is_old_format):
        if is_old_format and "compatibility_load" not in kwargs:
            warnings.warn(
                "Old-format checkpoint detected ('check_errors' in "
                "hyper_parameters); applying compatibility_load remap.")
        if args["model"] in ("tensornet", "tensornet2"):
            keys = ["representation_model.tensor_embedding.linears_scalar.1"]
            if args["model"] == "tensornet":
                keys += [f"representation_model.layers.{i}.linears_scalar.2"
                         for i in range(args["num_layers"])]
            for k in keys:
                sd[k + ".weight"], sd[k + ".bias"] = remix_linear(
                    sd[k + ".weight"], sd[k + ".bias"])
    return sd


def load_weights(module, sd) -> None:
    """Load the compat-normalized ``sd`` into ``module``, strictly: the
    skipped buffers, the frozen rbf buffers and a non-trainable Atomref's
    table (which come in through the constructors) are left out; a key
    left over or one missing raises ``KeyError`` with its name, a shape
    mismatch ``ValueError`` (JAX ``convert_state_dict``,
    ``torch_ckpt.py:141-208``)."""
    want = module.state_dict()
    out, unmatched = {}, []
    for key, value in sd.items():
        if is_skipped(key):
            continue
        if key not in want:
            leaf = key.rsplit(".", 1)[-1]
            if leaf in RBF_BUFFERS or key.endswith("atomref.weight"):
                continue
            unmatched.append(key)
            continue
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"Shape mismatch for {key}: ckpt "
                             f"{tuple(value.shape)} vs model "
                             f"{tuple(want[key].shape)}")
        out[key] = value
    if unmatched:
        raise KeyError(f"Unmapped checkpoint keys: {unmatched}")
    missing = [k for k in want if k not in out]
    if missing:
        raise KeyError("Checkpoint did not provide values for: "
                       + ", ".join(missing))
    module.load_state_dict(out, strict=True)


def _with_table(prior, table=None, enable=None):
    """A copy of the Atomref ``prior`` with another table or switch."""
    return type(prior)(
        initial_atomref=(prior._table() if table is None else table)
        .detach().cpu().numpy(),
        trainable=prior.trainable,
        enable=prior.enable if enable is None else enable)


def load_checkpoint_as_potential(filepath, args=None, device=None,
                                 **kwargs):
    """The reference-compatible loader behind ``models/model.py::
    load_model`` (JAX ``torch_ckpt.py:363-456``); returns a ``Potential``
    on ``device``.  No template is needed: the port's state dict has the
    checkpoint's names."""
    from torchmdnet_tpu_torch.models.model import (
        create_model, create_prior_models)
    from torchmdnet_tpu_torch.priors import Atomref

    hparams, raw_sd = read_torch_checkpoint(filepath)
    args = dict(hparams) if args is None else dict(args)
    delta_learning = args.get("remove_ref_energy", False)
    for key, value in kwargs.items():
        if key == "compatibility_load":
            continue
        if key not in args:
            warnings.warn(f"Unknown hyperparameter: {key}={value}")
        args[key] = value
    if args.get("model") in ("tensornetv2_alt", "tensornet-nqe"):
        args["model"] = "tensornet2"

    sd = apply_reference_compat(raw_sd, args, hparams, kwargs)

    # the frozen rbf buffers, whatever values the checkpoint holds (a
    # re-fitted but frozen basis), through the constructor
    rbf_initial = None
    if not args.get("trainable_rbf", False):
        names = (("means", "betas")
                 if args.get("rbf_type", "expnorm") == "expnorm"
                 else ("offset", "coeff"))
        vals = [sd[_RBF_PREFIX + n] for n in names if _RBF_PREFIX + n in sd]
        if len(vals) == len(names):
            rbf_initial = tuple(vals)

    # priors from the hyperparameters; Atomref tables from the checkpoint
    prior_models = list(create_prior_models(args))
    for i, prior in enumerate(prior_models):
        key = f"prior_model.{i}.atomref.weight"
        if isinstance(prior, Atomref) and key in sd:
            prior_models[i] = _with_table(prior, sd[key])
            if not prior.trainable:
                del sd[key]
    if delta_learning and "remove_ref_energy" in kwargs and (
            not kwargs["remove_ref_energy"]):
        if not prior_models:
            raise ValueError("Atomref prior must be added during training "
                             "(with enable=False) for total energy "
                             "prediction.")
        if not isinstance(prior_models[-1], Atomref):
            raise ValueError("Expected the last prior to be Atomref.")
        prior_models[-1] = _with_table(prior_models[-1], enable=True)

    mean = float(raw_sd.get("model.mean", raw_sd.get("mean", 0.0)))
    std = float(raw_sd.get("model.std", raw_sd.get("std", 1.0)))
    potential = create_model(args, prior_models=tuple(prior_models),
                             mean=mean, std=std, device=device,
                             rbf_initial=rbf_initial)
    load_weights(potential.module, sd)
    return potential
