"""The port's optimizer pieces against optax on the CPU:
``clip_by_global_norm_`` against ``optax.clip_by_global_norm``, and the
port's AdamW against ``optax.adamw`` and against the JAX step's own
``make_optimizer`` (clip chained before AdamW, the LR injected per step),
with an LR and a weight decay large enough that decay left out, or put
on the updated parameter in place of the old one, fails by far."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import ATOL, RTOL, one_torch_thread  # noqa: F401
from torchmdnet_tpu.train.step import make_optimizer as jax_make_optimizer
from torchmdnet_tpu_torch.train.step import (clip_by_global_norm_,
                                             make_optimizer)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = ((4, 3), (5,), (2, 2, 3))
N_UPDATES = 3


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(s)).astype(np.float32)
            for s in SHAPES]


def _optax_run(opt, params, grads_seq, lrs=None):
    """``params`` after one optax update per gradient, with the injected
    learning rate set to ``lrs[i]`` before update ``i`` when given."""
    params = [jnp.asarray(p) for p in params]
    state = opt.init(params)
    for i, grads in enumerate(grads_seq):
        if lrs is not None:
            inner = state if hasattr(state, "hyperparams") else state[1]
            inner.hyperparams["learning_rate"] = jnp.asarray(lrs[i])
        updates, state = opt.update([jnp.asarray(g) for g in grads], state,
                                    params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


def _port_run(params, grads_seq, lrs, weight_decay, clip=0.0):
    """The port's update, as ``make_train_step`` makes it: clip in place,
    the LR written into the param group, ``optimizer.step``."""
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make_optimizer(ps, weight_decay)
    for grads, lr in zip(grads_seq, lrs):
        gs = [torch.from_numpy(g.copy()) for g in grads]
        if clip > 0:
            clip_by_global_norm_(gs, clip)
        for group in opt.param_groups:
            group["lr"] = lr
        for p, g in zip(ps, gs):
            p.grad = g
        opt.step()
    return [p.detach().numpy() for p in ps]


def _assert_trees_close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Clipped (norm ≈ 6 > 0.5) and left alone (norm < 1e3)."""
    grads = _tree(1)
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads)))
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm_(got, max_norm)
    got = [g.numpy() for g in got]
    _assert_trees_close(got, [np.asarray(w) for w in want])
    if norm > max_norm:
        got_norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                               for g in got))
        np.testing.assert_allclose(got_norm, max_norm, rtol=1e-6)
    else:
        for a, b in zip(got, grads):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lr,weight_decay", [(0.1, 0.5), (0.1, 0.0),
                                             (1e-3, 0.05)])
def test_adamw_matches_optax(lr, weight_decay):
    """Three updates of the port's AdamW against ``optax.adamw``; at lr
    0.1 and decay 0.5 each update decays a weight by 5% of itself, and
    optax without decay, or with the decay on the updated weight, is far
    outside the tolerance."""
    params = _tree(2, scale=3.0)
    grads_seq = [_tree(10 + i) for i in range(N_UPDATES)]
    got = _port_run(params, grads_seq, [lr] * N_UPDATES, weight_decay)
    want = _optax_run(optax.adamw(lr, weight_decay=weight_decay), params,
                      grads_seq)
    _assert_trees_close(got, want)
    if weight_decay * lr >= 0.01:
        undecayed = _optax_run(optax.adamw(lr, weight_decay=0.0), params,
                               grads_seq)
        assert _max_diff(got, undecayed) > 100 * ATOL
        # decay applied to the Adam-updated weight instead of the old one
        late = _optax_run(optax.chain(
            optax.scale_by_adam(), optax.scale(-lr),
            _decay_after(lr * weight_decay)), params, grads_seq)
        assert _max_diff(got, late) > 10 * ATOL


def _decay_after(rate):
    """An update that also decays the *updated* parameter: ``u ← u −
    rate·(p + u)``."""
    def update(updates, state, params):
        return [u - rate * (p + u) for u, p in zip(updates, params)], state
    return optax.GradientTransformation(lambda _: optax.EmptyState(), update)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_step_optimizer_matches_jax_make_optimizer(clip):
    """The port's clip + AdamW as the train step drives it against the
    JAX step's ``make_optimizer(weight_decay, gradient_clipping)``, with
    the LR changed between updates as warmup changes it."""
    lrs = [0.05, 0.1, 0.1]
    params = _tree(3, scale=2.0)
    grads_seq = [_tree(20 + i) for i in range(N_UPDATES)]
    got = _port_run(params, grads_seq, lrs, 0.5, clip)
    want = _optax_run(jax_make_optimizer(0.5, clip), params, grads_seq, lrs)
    _assert_trees_close(got, want)
