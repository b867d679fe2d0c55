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
    ``init="xavier_zeros"`` a xavier-uniform weight and zero bias.

    It computes in ``compute_dtype`` (bfloat16 under ``precision=16``,
    :func:`set_compute_dtype`) or else in the input's dtype, the weights
    cast to it and kept in their own, as JAX's ``Linear(dtype=…)`` does
    (``models/common.py:83-92``)."""

    compute_dtype = None

    def __init__(self, in_features, out_features, bias=True, init="torch"):
        if init not in ("torch", "xavier_zeros"):
            raise ValueError(init)
        self.init = init
        super().__init__(in_features, out_features, bias=bias)

    def forward(self, x):
        dt = self.compute_dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F_.linear(x.to(dt), self.weight.to(dt), bias)

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
    """N(0, 1) embedding; its rows come out in ``compute_dtype`` when set
    (JAX ``Embedding(dtype=…)``)."""

    compute_dtype = None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def forward(self, idx):
        out = super().forward(idx)
        return out if self.compute_dtype is None else out.to(
            self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the torch epsilon (1e-5); keys ``weight``/``bias``.
    It normalises in at least float32 and returns the input's dtype (JAX
    ``LayerNorm``, ``models/common.py:148-152``)."""

    def __init__(self, dim):
        super().__init__(dim, eps=1e-5)

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, torch.float32)
        y = F_.layer_norm(x.to(dt), self.normalized_shape,
                          self.weight.to(dt), self.bias.to(dt), self.eps)
        return y.to(x.dtype)


class GLU(nn.Module):
    """Gated linear unit ``W(x) * activation(V(x))`` (reference ``GLU``,
    ``models/utils.py:410-437``, JAX ``models/common.py:181-193``);
    submodules ``W`` and ``V``, torch-default initialisation."""

    def __init__(self, in_channels, hidden_channels, activation=torch.sigmoid):
        super().__init__()
        self.W = Linear(in_channels, hidden_channels)
        self.V = Linear(in_channels, hidden_channels)
        self.activation = activation

    def forward(self, x):
        return self.W(x) * self.activation(self.V(x))


class SwiGLU(nn.Module):
    """GLU gated by Swish, ``v · sigmoid(β v)`` (reference ``SwiGLU``,
    ``models/utils.py:476-499``, JAX ``models/common.py:196-208``); wraps
    a ``glu`` submodule."""

    def __init__(self, in_channels, hidden_features, beta=1.0):
        super().__init__()
        self.beta = float(beta)
        self.glu = GLU(in_channels, hidden_features, activation=self._swish)

    def _swish(self, v):
        return v * torch.sigmoid(self.beta * v)

    def forward(self, x):
        return self.glu(x)


def set_compute_dtype(module: nn.Module, dtype, skip=()) -> None:
    """Give every layer under ``module`` that has a ``compute_dtype``
    (:class:`Linear`, :class:`Embedding`, TensorNet's ``PairLinear``; but
    those under a module of a type in ``skip``) the compute dtype
    ``dtype``: JAX's ``dtype=`` of a representation model, which its
    charge heads do not take."""
    def visit(m):
        if isinstance(m, skip):
            return
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = dtype
        for child in m.children():
            visit(child)
    visit(module)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter of ``module`` from ``generator``, in
    module order (every parametrised module of the port subclasses one of
    these and takes a generator)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, nn.LayerNorm)):
            m.reset_parameters(generator)


def _initial(values, default):
    """A checkpoint's frozen buffer ``values`` (any array-like) in the
    shape of the ``default`` buffer; ``default`` when None."""
    if values is None:
        return default
    t = torch.as_tensor(values, dtype=torch.float32).detach().cpu().clone()
    if t.numel() != default.numel():
        raise ValueError(f"a frozen rbf buffer of {t.numel()} values where "
                         f"the model has {default.numel()}")
    return t.reshape(default.shape)


class ExpNormalSmearing(nn.Module):
    """Expnorm radial basis (reference ``models/utils.py:356-407``).  With
    ``trainable`` the means and betas are parameters under upstream's
    names (``distance_expansion.means``/``.betas``, JAX's params of the
    same names); otherwise fixed buffers outside the state dict, as in
    the JAX package, which then has no parameters for them.
    ``initial_values``: ``(means, betas)`` from a checkpoint (JAX's
    ``rbf_initial``), in place of the PhysNet defaults."""

    def __init__(self, cutoff_lower=0.0, cutoff_upper=5.0, num_rbf=50,
                 trainable=False, initial_values=None):
        super().__init__()
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        self.alpha = 5.0 / (cutoff_upper - cutoff_lower)
        means, betas = rbf_ops.expnorm_initial_params(cutoff_lower,
                                                      cutoff_upper, num_rbf)
        if initial_values is not None:
            means = _initial(initial_values[0], means)
            betas = _initial(initial_values[1], betas)
        _register(self, trainable, means=means, betas=betas)

    def values(self):
        """The buffers (or parameters), in the order ``initial_values``
        takes them."""
        return self.means, self.betas

    def forward(self, dist):
        return rbf_ops.expnorm_rbf(dist, self.means, self.betas, self.alpha,
                                   self.cutoff_upper, self.cutoff_lower)


class GaussianSmearing(nn.Module):
    """Gaussian radial basis (reference ``models/utils.py:316-353``, JAX
    ``models/common.py:262-290``); the offsets and the (scalar)
    coefficient are parameters ``offset``/``coeff`` with ``trainable``,
    else fixed buffers outside the state dict.  ``initial_values``:
    ``(offset, coeff)`` from a checkpoint."""

    def __init__(self, cutoff_lower=0.0, cutoff_upper=5.0, num_rbf=50,
                 trainable=False, initial_values=None):
        super().__init__()
        self.cutoff_lower = cutoff_lower
        self.cutoff_upper = cutoff_upper
        offset, coeff = rbf_ops.gauss_initial_params(cutoff_lower,
                                                     cutoff_upper, num_rbf)
        if initial_values is not None:
            offset = _initial(initial_values[0], offset)
            coeff = _initial(initial_values[1], coeff)
        _register(self, trainable, offset=offset, coeff=coeff)

    def values(self):
        return self.offset, self.coeff

    def forward(self, dist):
        return rbf_ops.gauss_rbf(dist, self.offset, self.coeff)


def _register(module, trainable, **tensors):
    """The smearing's tensors as parameters (``trainable``) or as
    non-persistent buffers."""
    for name, t in tensors.items():
        if trainable:
            module.register_parameter(name, nn.Parameter(t))
        else:
            module.register_buffer(name, t, persistent=False)


RBF_CLASSES = {"gauss": GaussianSmearing, "expnorm": ExpNormalSmearing}


def make_rbf(rbf_type, cutoff_lower, cutoff_upper, num_rbf, trainable,
             initial_values=None):
    if rbf_type not in RBF_CLASSES:
        raise ValueError(f'Unknown RBF type "{rbf_type}". Choose from '
                         f'{", ".join(RBF_CLASSES)}.')
    return RBF_CLASSES[rbf_type](cutoff_lower, cutoff_upper, num_rbf,
                                 trainable, initial_values)


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


class GatedEquivariantBlock(nn.Module):
    """Gated equivariant block of Schütt et al. 2021 (reference
    ``models/utils.py:583-655``, JAX ``models/common.py:337-381``); keys
    ``vec1_proj``, ``vec2_proj``, ``update_net.layers.N`` as upstream
    writes them after its PR#314.  ``x [N, H]``, ``v [N, 3, H]`` →
    ``(x [N, O], v [N, 3, O])``.  The norm of ``vec1`` has a zero-safe
    gradient (a double ``where``, as in JAX)."""

    def __init__(self, hidden_channels, out_channels,
                 intermediate_channels=None, activation="silu",
                 scalar_activation=False):
        super().__init__()
        self.out_channels = out_channels
        inter = intermediate_channels or hidden_channels
        self.vec1_proj = Linear(hidden_channels, hidden_channels, bias=False,
                                init="xavier_zeros")
        self.vec2_proj = Linear(hidden_channels, out_channels, bias=False,
                                init="xavier_zeros")
        self.update_net = MLP(2 * hidden_channels, out_channels * 2, inter,
                              activation)
        self.act = get_activation(activation) if scalar_activation else None

    def forward(self, x, v):
        vec1_buffer = self.vec1_proj(v)
        sq = (vec1_buffer * vec1_buffer).sum(dim=-2)
        nonzero_row = (vec1_buffer != 0).reshape(
            vec1_buffer.shape[0], -1).any(dim=1)
        keep = (sq > 0) & nonzero_row[:, None]
        vec1 = torch.where(keep, torch.sqrt(torch.where(keep, sq, 1.0)), 0.0)
        vec2 = self.vec2_proj(v)
        x = self.update_net(torch.cat([x, vec1], dim=-1))
        x, vgate = torch.split(x, self.out_channels, dim=-1)
        v = vgate[:, None, :] * vec2
        if self.act is not None:
            x = self.act(x)
        return x, v
