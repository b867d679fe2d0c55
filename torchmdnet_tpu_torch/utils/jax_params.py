"""Carry the JAX package's weights into the port.

:func:`params_from_jax` maps the flax ``params`` tree, flattened to
``/``-joined paths, onto the port's state dict.  Keys are the upstream
torchmd-net names, as ``torchmdnet_tpu/utils/torch_ckpt.py::
_flax_path_to_torch_key`` (``:212``) writes them: a trailing ``_<int>``
becomes a list index (``layers_0`` → ``layers.0``) except on names whose
suffix is literal (``charge_predict_0``), ``kernel`` becomes a transposed
``weight``, ``embedding``/``scale`` become ``weight``, and a trainable
Atomref's table (``prior_models_<i>/atomref``) becomes
``prior_model.<i>.atomref.weight`` (``torch_ckpt.py:135-136``, ``:234-239``), and
TorchMD-GN's filter network, which JAX keeps under its convolution
(``interactions_<i>/conv/net_<j>``), becomes upstream's
``interactions.<i>.mlp.<j>`` (``:241-243``).  This is a copy of that
mapping, not an import of the JAX package.
"""

import re
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

# names whose trailing _<int> is part of the torch attribute name
_LITERAL = {"charge_predict_0", "output_network_0", "output_network_1"}
# TorchMD-GN's filter network: ``conv.net.<j>`` (where upstream's CFConv
# reads it, and JAX keeps it) → ``mlp.<j>`` (where upstream's
# InteractionBlock owns it, and the port and JAX's files keep it)
GN_FILTER_ALIAS = (re.compile(r"(interactions\.\d+)\.conv\.net\.(\d+)\."),
                   r"\1.mlp.\2.")


def flax_path_to_torch_key(path) -> str:
    """``("layers_0", "linears_scalar_1", "kernel")`` →
    ``"layers.0.linears_scalar.1.weight"``."""
    tokens = []
    for tok in path[:-1]:
        head, _, tail = tok.rpartition("_")
        if tok not in _LITERAL and head and tail.isdigit():
            tokens += [head, tail]
        else:
            tokens.append(tok)
    leaf = path[-1]
    if leaf == "atomref":
        tokens += ["atomref", "weight"]
    else:
        tokens.append("weight" if leaf in ("kernel", "embedding", "scale")
                      else leaf)
    if tokens[0] == "prior_models":
        tokens[0] = "prior_model"
    return GN_FILTER_ALIAS[0].sub(GN_FILTER_ALIAS[1], ".".join(tokens))


def params_from_jax(flat: Dict[str, np.ndarray]) -> "OrderedDict[str, torch.Tensor]":
    """``{"representation_model/tensor_embedding/emb/embedding": array, …}``
    → a state dict the port's :class:`~torchmdnet_tpu_torch.models.model.
    TorchMDNet` loads with ``strict=True``."""
    out = OrderedDict()
    for name, value in flat.items():
        path = tuple(name.split("/"))
        arr = np.asarray(value, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.T
        # the equivariant heads' blocks: JAX's files keep the literal
        # ``output_network_0``, the port's ModuleList is ``output_network.0``
        key = re.sub(r"(^|\.)output_network_(\d+)\.", r"\1output_network.\2.",
                     flax_path_to_torch_key(path))
        if key in out:
            raise KeyError(f"two JAX parameters map to {key!r}")
        out[key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out
