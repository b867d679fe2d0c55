"""What the inputs ask of the model, counted from the positions: atoms,
molecules, the directed pairs within the model's cutoff (the self pair of
each atom included, as the model's sums include it) and the pairs of the
Coulomb head.  Nothing here reads the program's lists, slots or padding,
so the work is the same whatever implements it."""

import torch

ROW_BLOCK = 1024


@torch.no_grad()
def count_within(pos, batch, cutoff, box=None):
    """Directed pairs ``i != j`` of one molecule with ``d_ij < cutoff``
    (minimum image in the orthorhombic ``box`` lengths, if given)."""
    n = pos.shape[0]
    total = 0
    for s in range(0, n, ROW_BLOCK):
        e = min(n, s + ROW_BLOCK)
        delta = pos[s:e, None, :] - pos[None, :, :]
        if box is not None:
            delta = delta - torch.round(delta / box) * box
        d2 = (delta * delta).sum(-1)
        hit = (d2 < cutoff * cutoff) & (batch[s:e, None] == batch[None, :])
        total += int(hit.sum()) - (e - s)   # the diagonal
    return total


def geometry(cfg, pos, batch, box=None):
    """``{"atoms", "molecules", "pairs", "coulomb_pairs"}``: ``pairs``
    within ``cutoff_upper`` with the self pairs, ``coulomb_pairs`` within
    ``coulomb_cutoff`` or, without one, every ordered pair of atoms of
    one molecule."""
    n = int(pos.shape[0])
    counts = torch.bincount(batch)
    pairs = count_within(pos, batch, float(cfg["cutoff_upper"]), box) + n
    rc = cfg.get("coulomb_cutoff")
    if rc is None:
        coulomb = int((counts * (counts - 1)).sum())
    else:
        coulomb = count_within(pos, batch, float(rc), box)
    return {"atoms": n, "molecules": int((counts > 0).sum()),
            "pairs": pairs, "coulomb_pairs": coulomb}


def widths(cfg):
    """``(F, R, q, layers)`` of the configuration."""
    return (cfg["embedding_dimension"], cfg["num_rbf"], cfg["q_dim"],
            cfg["num_layers"])
