"""Shared building blocks; counterpart of ``torchmdnet_tpu/models/common.py``.

Module attribute names mirror the upstream torchmd-net ones, so a state
dict carries upstream key names (``layers.0.weight`` …) and loads the
weights of a JAX model through ``utils/jax_params.py``.  Parameters are
initialised from an explicit ``torch.Generator`` with the statistics of
the JAX package: torch-default ``U(±1/√fan_in)`` for linear layers,
xavier-uniform weights and zero biases inside :class:`MLP`, N(0, 1)
embeddings.
"""

import math

import torch
import torch.nn.functional as F_
from torch import nn

from torchmdnet_tpu_torch.ops import rbf as rbf_ops


def _shifted_softplus(x):
    return F_.softplus(x) - math.log(2.0)


def _mish(x):
    return x * torch.tanh(F_.softplus(x))


ACTIVATIONS = {
    "ssp": _shifted_softplus,
    "silu": F_.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "swish": F_.silu,
    "mish": _mish,
}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f'Unknown activation function "{name}". '
                         f'Choose from {", ".join(ACTIVATIONS)}.')
    return ACTIVATIONS[name]


class Activation(nn.Module):
    def __init__(self, name: str):
        super().__init__()
        self.name = name
        self.fn = get_activation(name)

    def forward(self, x):
        return self.fn(x)


class Linear(nn.Linear):
    """``nn.Linear`` whose initialisation follows the JAX package:
    ``init="torch"`` gives U(±1/√fan_in) weight and bias;
    ``init="xavier_zeros"`` a xavier-uniform weight and zero bias."""

    def __init__(self, in_features, out_features, bias=True, init="torch"):
        if init not in ("torch", "xavier_zeros"):
            raise ValueError(init)
        self.init = init
        super().__init__(in_features, out_features, bias=bias)

    def reset_parameters(self, generator=None):
        fan_in, fan_out = self.in_features, self.out_features
        with torch.no_grad():
            if self.init == "torch":
                bound = 1.0 / math.sqrt(fan_in)
                self.weight.uniform_(-bound, bound, generator=generator)
                if self.bias is not None:
                    self.bias.uniform_(-bound, bound, generator=generator)
            else:
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                self.weight.uniform_(-bound, bound, generator=generator)
                if self.bias is not None:
                    self.bias.zero_()


class Embedding(nn.Embedding):
    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(generator=generator)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the torch epsilon (1e-5); keys ``weight``/``bias``."""

    def __init__(self, dim):
        super().__init__(dim, eps=1e-5)

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``module`` from ``generator``, in
    module order (every parametrised module of the port subclasses one of
    these and takes a generator)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, nn.LayerNorm)):
            m.reset_parameters(generator)


class ExpNormalSmearing(nn.Module):
    """Expnorm radial basis (reference ``models/utils.py:356-407``).  Not
    trainable: means and betas are fixed buffers outside the state dict,
    as in the JAX package, which has no parameters for them."""

    def __init__(self, cutoff_lower=0.0, cutoff_upper=5.0, num_rbf=50,
                 trainable=False):
        super().__init__()
        if trainable:
            raise NotImplementedError(
                "trainable_rbf (trainable smearing) is not ported yet "
                "(ROADMAP Queue 1 item 17, 'Training: trainable_rbf')")
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.alpha = 5.0 / (cutoff_upper - cutoff_lower)
        means, betas = rbf_ops.expnorm_initial_params(cutoff_lower,
                                                      cutoff_upper, num_rbf)
        self.register_buffer("means", means, persistent=False)
        self.register_buffer("betas", betas, persistent=False)

    def forward(self, dist):
        return rbf_ops.expnorm_rbf(dist, self.means, self.betas, self.alpha,
                                   self.cutoff_upper, self.cutoff_lower)


def make_rbf(rbf_type, cutoff_lower, cutoff_upper, num_rbf, trainable):
    if rbf_type != "expnorm":
        raise NotImplementedError(
            f"rbf_type={rbf_type!r}: only 'expnorm' is ported (ROADMAP "
            "Queue 1, 'models/common.py')")
    return ExpNormalSmearing(cutoff_lower, cutoff_upper, num_rbf, trainable)


class MLP(nn.Module):
    """Linear/activation stack; ``layers`` indices (0, 2, 4, …) match the
    upstream ``nn.Sequential``."""

    def __init__(self, in_channels, out_channels, hidden_channels,
                 activation="silu", num_hidden_layers=0):
        super().__init__()
        widths = [in_channels] + [hidden_channels] * (1 + num_hidden_layers)
        mods = []
        for a, b in zip(widths[:-1], widths[1:]):
            mods += [Linear(a, b, init="xavier_zeros"), Activation(activation)]
        mods.append(Linear(widths[-1], out_channels, init="xavier_zeros"))
        self.layers = nn.Sequential(*mods)

    def forward(self, x):
        return self.layers(x)
