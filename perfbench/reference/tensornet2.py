"""Plain PyTorch reference of TensorNet2 with the weighted Coulomb head.

The energy of the AceFF recipe's model (TensorNet2, "AceFF-2.0" style:
Simeon & De Fabritiis' TensorNet with AIMNet2-style charge equilibration
and a multi-channel predicted-charge Coulomb head), written from the
equations on an explicit list of directed pairs and full 3x3 tensors, in
float32.  It imports nothing of the program under test: the weights are
made here from the seed (:func:`make_weights`), under the upstream
checkpoint's names, and handed to both sides.

Conventions (upstream torchmd-net): pairs ``(i, j)`` within the cutoff
include the self pair ``(i, i)``; ``delta = pos_i - pos_j`` under the
minimum image of an orthorhombic box; ``v = delta / d`` (0 for the self
pair).  Per node and channel a rank-2 tensor ``X [N, 3, 3, F]`` is split
into ``I = tr X / 3``, ``A = (X - X^T) / 2`` and ``S = (X + X^T) / 2 - I``.

Memory: pair work runs in chunks under ``torch.utils.checkpoint``, so the
backward recomputes each chunk instead of keeping its activations: 25,088
atoms at 10 A Coulomb fit in a few GB.

``tf32=True`` is the control of the check: every matrix product runs on
operands rounded to TF32 (10-bit mantissa), and on CUDA with
``allow_tf32`` on, which is what a float32 model computed on the tensor
cores in TF32 gives.
"""

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F_
from torch.utils.checkpoint import checkpoint

# 0.5 * Hartree * Bohr (eV * A): the head's Coulomb constant over 2
COULOMB_FACTOR = 0.5 * 27.211386024367243 * 0.5291772105638411
DAMP_RC = 4.6          # AIMNet2 short-range damping radius, A
EPS_SOLVENT = 78.3     # reaction-field dielectric of the cutoff head
PAIR_CHUNK = 1 << 17   # pairs a chunk of the representation
COULOMB_CHUNK = 1 << 20
ROW_BLOCK = 1024       # rows a block of the pair search


# ------------------------------------------------------------------ weights
def param_table(cfg):
    """``[(name, shape, init)]`` of the model's parameters, in upstream
    checkpoint names.  ``init``: ``("uniform", bound)``, ``("normal",
    std)`` or ``("const", value)``; the statistics of upstream's
    initialisation (torch-default linears, xavier-uniform MLPs with zero
    biases, N(0, 1) embeddings, unit LayerNorms)."""
    f, r, q = cfg["embedding_dimension"], cfg["num_rbf"], cfg["q_dim"]
    rows = []

    def linear(name, fan_in, fan_out, bias=True):
        b = 1.0 / math.sqrt(fan_in)
        rows.append((name + ".weight", (fan_out, fan_in), ("uniform", b)))
        if bias:
            rows.append((name + ".bias", (fan_out,), ("uniform", b)))

    def xavier(name, fan_in, fan_out):
        b = math.sqrt(6.0 / (fan_in + fan_out))
        rows.append((name + ".weight", (fan_out, fan_in), ("uniform", b)))
        rows.append((name + ".bias", (fan_out,), ("const", 0.0)))

    def norm(name, width):
        rows.append((name + ".weight", (width,), ("const", 1.0)))
        rows.append((name + ".bias", (width,), ("const", 0.0)))

    def charge_head(name):
        norm(name + ".q_norm", 3 * f)
        xavier(name + ".q_mlp.layers.0", 3 * f, f)
        xavier(name + ".q_mlp.layers.2", f, f)
        xavier(name + ".q_mlp.layers.4", f, 2 * q)

    rep = "representation_model."
    te = rep + "tensor_embedding."
    rows.append((te + "emb.weight", (cfg["max_z"], f), ("normal", 1.0)))
    linear(te + "emb2", 2 * f, f)
    for k in (1, 2, 3):
        linear(te + f"distance_proj{k}", r, f)
    norm(te + "init_norm", f)
    linear(te + "linears_scalar.0", f, 2 * f)
    linear(te + "linears_scalar.1", 2 * f, 3 * f)
    for k in range(3):
        linear(te + f"linears_tensor.{k}", f, f, bias=False)
    charge_head(rep + "charge_predict_0")
    for layer in range(cfg["num_layers"]):
        p = rep + f"layers.{layer}."
        linear(p + "linears_scalar.0", r + 2 * q, f)
        linear(p + "linears_scalar.1", f, 2 * f)
        linear(p + "linears_scalar.2", 2 * f, 3 * f)
        for k in range(6):
            linear(p + f"linears_tensor.{k}", f, f, bias=False)
    for layer in range(cfg["num_layers"]):
        charge_head(rep + f"charge_predicts.{layer}")
    norm(rep + "out_norm", 3 * f)
    linear(rep + "linear", 3 * f, f)
    xavier("output_model.output_network.layers.0", f, f // 2)
    xavier("output_model.output_network.layers.2", f // 2, 1)
    return rows


def make_weights(cfg, seed, device):
    """The parameters of :func:`param_table` from ``seed``, made on
    ``device`` with one uniform and one normal draw of a
    ``torch.Generator`` there."""
    table = param_table(cfg)
    sizes = [math.prod(shape) for _, shape, _ in table]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, (kind, v)), n in zip(table, sizes):
        if kind == "uniform":
            t = uni[at:at + n] * v
        elif kind == "normal":
            t = nor[at:at + n] * v
        else:
            t = torch.full((n,), float(v), device=device)
        out[name] = t.view(shape).clone()
        at += n
    return out


# ---------------------------------------------------------------- precision
def _round_tf32(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even); the
    gradient passes through unchanged."""
    b = x.detach().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return x + (b.view(torch.float32) - x).detach()


class Precision:
    """How :func:`linear` multiplies: float32, or TF32 (the control)."""

    tf32 = False


@contextmanager
def precision(tf32: bool):
    """Every product inside runs in TF32 (``tf32``) or in full float32
    (TF32 off on CUDA too)."""
    old = (Precision.tf32, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    Precision.tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (Precision.tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def linear(x, w, b=None):
    if Precision.tf32:
        x, w = _round_tf32(x), _round_tf32(w)
    return F_.linear(x, w, b)


def silu(x):
    return x * torch.sigmoid(x)


# ------------------------------------------------------------------- pairs
@torch.no_grad()
def pairs_within(pos, batch, cutoff, box=None, self_pairs=False):
    """Directed pairs ``(i, j)`` of one molecule with ``d_ij < cutoff``
    (``i != j``; with ``self_pairs`` also ``(i, i)``), by a search over
    row blocks; ``box``: the orthorhombic box's three lengths or None.
    Returns ``(i, j, shift)`` with ``pos_i - pos_j + shift`` the minimum
    image, sorted by ``i``."""
    n = pos.shape[0]
    out_i, out_j, out_s = [], [], []
    for s in range(0, n, ROW_BLOCK):
        e = min(n, s + ROW_BLOCK)
        delta = pos[s:e, None, :] - pos[None, :, :]
        shift = torch.zeros_like(delta)
        if box is not None:
            shift = -torch.round(delta / box) * box
        d2 = ((delta + shift) ** 2).sum(-1)
        hit = (d2 < cutoff * cutoff) & (batch[s:e, None] == batch[None, :])
        rows = torch.arange(s, e, device=pos.device)
        hit[rows - s, rows] = self_pairs
        ii, jj = hit.nonzero(as_tuple=True)
        out_i.append(ii + s)
        out_j.append(jj)
        out_s.append(shift[ii, jj])
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_s)


def _geometry(pos, i, j, shift):
    """``(delta, d, v)`` of the pairs, differentiable in ``pos``; the self
    pair has ``d = 0`` and ``v = 0`` with a finite gradient."""
    delta = pos[i] - pos[j] + shift
    d2 = (delta * delta).sum(-1)
    nz = d2 > 0
    d = torch.where(nz, torch.sqrt(torch.where(nz, d2, 1.0)), 0.0)
    v = delta / torch.where(nz, d, 1.0)[:, None]
    return delta, d, v


def _chunks(n, size):
    return [(s, min(n, s + size)) for s in range(0, n, size)]


def _pair_sum(fn, n_nodes, pairs, chunk, *tensors):
    """``out[i] += fn(i, j, shift, *tensors)`` over chunks of the pairs,
    each under ``checkpoint`` (recomputed in the backward)."""
    i, j, shift = pairs
    out = None
    for s, e in _chunks(i.shape[0], chunk):
        part = checkpoint(fn, i[s:e], j[s:e], shift[s:e], *tensors,
                          use_reentrant=False)
        if out is None:
            out = part.new_zeros((n_nodes,) + part.shape[1:])
        out = out.index_add(0, i[s:e], part)
    return out


# ------------------------------------------------------------------- model
def cosine_cutoff(d, hi):
    return 0.5 * (torch.cos(d * (math.pi / hi)) + 1.0) * (d < hi)


def expnorm(d, lo, hi, num_rbf):
    """PhysNet's expnorm basis with its default means and widths."""
    start = math.exp(-hi + lo)
    means = torch.linspace(start, 1.0, num_rbf, device=d.device)
    beta = (2.0 / num_rbf * (1.0 - start)) ** -2
    alpha = 5.0 / (hi - lo)
    arg = torch.exp(alpha * (lo - d[:, None])) - means
    return cosine_cutoff(d, hi)[:, None] * torch.exp(-beta * arg * arg)


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)[:, :, None]


def decompose(x):
    """``(I [N, F], A [N, 3, 3, F], S [N, 3, 3, F])`` of ``x``."""
    i = (x[:, 0, 0] + x[:, 1, 1] + x[:, 2, 2]) / 3.0
    xt = x.transpose(1, 2)
    a = 0.5 * (x - xt)
    s = 0.5 * (x + xt) - i[:, None, None] * _eye(x)
    return i, a, s


def norms(x):
    """Squared Frobenius norms of the three parts, each ``[N, F]``."""
    i, a, s = decompose(x)
    return 3.0 * i * i, (a * a).sum((1, 2)), (s * s).sum((1, 2))


def mix(x, w3):
    """One channel-mixing linear per part: ``I``, ``A``, ``S`` by ``w3``."""
    i, a, s = decompose(x)
    return (linear(i, w3[0])[:, None, None] * _eye(x) + linear(a, w3[1])
            + linear(s, w3[2]))


def mat3(a, b):
    """Per node and channel 3x3 product, as a broadcast multiply-sum."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(2)


def layer_norm(x, w, b):
    return F_.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


def mlp(p, name, x, n_layers):
    for k in range(n_layers):
        x = linear(x, p[f"{name}.layers.{2 * k}.weight"],
                   p[f"{name}.layers.{2 * k}.bias"])
        if k < n_layers - 1:
            x = silu(x)
    return x


def segment_sum(x, seg, n):
    return x.new_zeros((n,) + x.shape[1:]).index_add(0, seg, x)


def charges_of(p, name, x, batch, q_mol, num_mols, q_dim):
    """Charge head and neutral charge equilibration: ``c + f^2 / (sum f^2
    + 1e-6) * (Q - sum c)`` per molecule."""
    i = decompose(x)[0]
    _, na, ns = norms(x)
    h = layer_norm(torch.cat([i, na, ns], -1), p[name + ".q_norm.weight"],
                   p[name + ".q_norm.bias"])
    cf = mlp(p, name + ".q_mlp", h, 3)
    c, f = cf[:, :q_dim], cf[:, q_dim:]
    fu = f * f
    fsum = segment_sum(fu, batch, num_mols) + 1e-6
    csum = segment_sum(c, batch, num_mols)
    return c + fu / fsum[batch] * (q_mol[batch][:, None] - csum[batch])


def _embedding_pairs(i, j, shift, pos, zw1, zw2, kall, ball, lo, hi, r):
    _, d, v = _geometry(pos, i, j, shift)
    dp = linear(expnorm(d, lo, hi, r), kall, ball)
    f = zw1.shape[-1]
    cz = cosine_cutoff(d, hi)[:, None] * (zw1[i] + zw2[j])
    w0, w1, w2 = (cz * dp[:, k * f:(k + 1) * f] for k in range(3))
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    zero = torch.zeros_like(vx)
    skew = torch.stack([zero, -vz, vy, vz, zero, -vx, -vy, vx, zero],
                       -1).view(-1, 3, 3)
    sym = v[:, :, None] * v[:, None, :] - (
        (v * v).sum(-1) / 3.0)[:, None, None] * torch.eye(3, device=v.device)
    eye = torch.eye(3, device=v.device)
    return (w0[:, None, None, :] * eye[None, :, :, None]
            + w1[:, None, None, :] * skew[..., None]
            + w2[:, None, None, :] * sym[..., None])


def _message_pairs(i, j, shift, pos, y, ui, uj, w1a, w2, b2, w3, b3, lo, hi,
                   r):
    _, d, _ = _geometry(pos, i, j, shift)
    pre = linear(expnorm(d, lo, hi, r), w1a) + ui[i] + uj[j]
    h = silu(linear(silu(linear(silu(pre), w2, b2)), w3, b3))
    attr = h * cosine_cutoff(d, hi)[:, None]
    f = y.shape[-1]
    yi, ya, ys = decompose(y[j])
    return (attr[:, None, None, :f] * yi[:, None, None] * _eye(y)
            + attr[:, None, None, f:2 * f] * ya
            + attr[:, None, None, 2 * f:] * ys)


def representation(p, cfg, z, pos, batch, q_mol, num_mols, pairs):
    """Atom features ``[N, F]`` and the per-layer charges ``[N, (L+1)q]``."""
    f, r, qd = cfg["embedding_dimension"], cfg["num_rbf"], cfg["q_dim"]
    lo, hi = float(cfg["cutoff_lower"]), float(cfg["cutoff_upper"])
    n = pos.shape[0]
    te = "representation_model.tensor_embedding."
    emb = p[te + "emb.weight"][z]
    w = p[te + "emb2.weight"]
    zw1 = linear(emb, w[:, :f], p[te + "emb2.bias"])
    zw2 = linear(emb, w[:, f:])
    kall = torch.cat([p[te + f"distance_proj{k}.weight"] for k in (1, 2, 3)])
    ball = torch.cat([p[te + f"distance_proj{k}.bias"] for k in (1, 2, 3)])
    x = _pair_sum(lambda i, j, s, pos, a, b, c, d: _embedding_pairs(
        i, j, s, pos, a, b, c, d, lo, hi, r), n, pairs, PAIR_CHUNK,
        pos, zw1, zw2, kall, ball)
    ni, na, ns = norms(x)
    h = layer_norm(ni + na + ns, p[te + "init_norm.weight"],
                   p[te + "init_norm.bias"])
    h = silu(linear(h, p[te + "linears_scalar.0.weight"],
                    p[te + "linears_scalar.0.bias"]))
    h = silu(linear(h, p[te + "linears_scalar.1.weight"],
                    p[te + "linears_scalar.1.bias"])).view(n, 3, f)
    i, a, s = decompose(x)
    lt = [p[te + f"linears_tensor.{k}.weight"] for k in range(3)]
    x = (linear(i, lt[0])[:, None, None] * h[:, None, None, 0] * _eye(x)
         + linear(a, lt[1]) * h[:, None, None, 1]
         + linear(s, lt[2]) * h[:, None, None, 2])
    rep = "representation_model."
    charges = charges_of(p, rep + "charge_predict_0", x, batch, q_mol,
                         num_mols, qd)
    all_charges = [charges]
    for layer in range(cfg["num_layers"]):
        lp = rep + f"layers.{layer}."
        lt = [p[lp + f"linears_tensor.{k}.weight"] for k in range(6)]
        ni, na, ns = norms(x)
        x = x / (ni + na + ns + 1.0)[:, None, None]
        y = mix(x, lt[:3])
        w1 = p[lp + "linears_scalar.0.weight"]
        ui = linear(charges, w1[:, r:r + qd], p[lp + "linears_scalar.0.bias"])
        uj = linear(charges, w1[:, r + qd:])
        m = _pair_sum(lambda i, j, s, *t: _message_pairs(
            i, j, s, *t, lo, hi, r), n, pairs, PAIR_CHUNK, pos, y, ui, uj,
            w1[:, :r], p[lp + "linears_scalar.1.weight"],
            p[lp + "linears_scalar.1.bias"], p[lp + "linears_scalar.2.weight"],
            p[lp + "linears_scalar.2.bias"])
        b = mat3(y, m) + mat3(m, y)
        ni, na, ns = norms(b)
        b = b / (ni + na + ns + 1.0)[:, None, None]
        dx = mix(b, lt[3:])
        x = x + dx + mat3(dx, dx)
        charges = charges_of(p, rep + f"charge_predicts.{layer}", x, batch,
                             q_mol, num_mols, qd)
        all_charges.append(charges)
    h = layer_norm(torch.cat(norms(x), -1), p[rep + "out_norm.weight"],
                   p[rep + "out_norm.bias"])
    h = silu(linear(h, p[rep + "linear.weight"], p[rep + "linear.bias"]))
    return h, torch.cat(all_charges, -1)


def _damping(d):
    t = torch.clamp(d / DAMP_RC, 0.0, 1.0 - 1e-6)
    return torch.exp(-1.0 / (1.0 - t * t)) / math.exp(-1.0)


def _coulomb_pairs(i, j, shift, pos, b, qw, rc):
    """``G(d) * sum_c qw_c b_ic b_jc`` per pair; ``rc`` None: the bare ``1/d``
    (all pairs of a molecule), else the reaction field at ``rc``."""
    _, d, _ = _geometry(pos, i, j, shift)
    pd = (qw * b[i] * b[j]).sum(-1)
    if rc is None:
        g = 1.0 / d
    else:
        k_rf = (1.0 / rc ** 3) * (EPS_SOLVENT - 1.0) / (2.0 * EPS_SOLVENT + 1)
        c_rf = (1.0 / rc) * (3.0 * EPS_SOLVENT) / (2.0 * EPS_SOLVENT + 1.0)
        g = 1.0 / d + k_rf * d * d - c_rf
    return (1.0 - _damping(d)) * g * pd


def atom_energies(p, cfg, z, pos, batch, q_mol, num_mols, box=None):
    """Per-atom energies ``[N]`` (eV): the scalar head plus the
    multi-channel Coulomb energy of the predicted charges.  ``box``: the
    orthorhombic box's lengths (the cutoff head needs one)."""
    pairs = pairs_within(pos, batch, float(cfg["cutoff_upper"]), box,
                         self_pairs=True)
    h, charges = representation(p, cfg, z, pos, batch, q_mol, num_mols,
                                pairs)
    e = _head(p, h)
    qw = torch.tensor(cfg["q_weights"], dtype=pos.dtype,
                      device=pos.device).flatten()
    rc = cfg.get("coulomb_cutoff")
    cpairs = pairs_within(pos, batch, math.inf if rc is None else float(rc),
                          box)
    e_c = _pair_sum(lambda i, j, s, pos, b, qw: _coulomb_pairs(
        i, j, s, pos, b, qw, None if rc is None else float(rc)),
        pos.shape[0], cpairs, COULOMB_CHUNK, pos, charges, qw)
    return e + COULOMB_FACTOR / qw.sum() * e_c


def _head(p, h):
    name = "output_model.output_network.layers."
    h = silu(linear(h, p[name + "0.weight"], p[name + "0.bias"]))
    return linear(h, p[name + "2.weight"], p[name + "2.bias"])[:, 0]


def energy_forces(p, cfg, z, pos, batch, q_mol, num_mols, box=None):
    """``(energies [num_mols], forces [N, 3], scale [num_mols])``: the
    molecules' energies, the forces ``-dE/dpos``, and each molecule's sum
    of ``|per-atom energy|``, the size an energy gap is measured against
    (a molecule's energy itself may lie near 0)."""
    pos = pos.detach().requires_grad_(True)
    with torch.enable_grad():
        e = atom_energies(p, cfg, z, pos, batch, q_mol, num_mols, box)
        (g,) = torch.autograd.grad(e.sum(), pos)
    e = e.detach()
    return (segment_sum(e, batch, num_mols), -g,
            segment_sum(e.abs(), batch, num_mols))
