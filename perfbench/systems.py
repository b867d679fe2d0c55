"""The systems a traffic mix runs on, made from the seed on the host.

Copies of the repository's generators (``chip_smoke.py``:
``northstar_system``, ``serve_molecule``, ``molecule_batch``,
``serve_batch``), with numpy's ``default_rng`` in place of
``RandomState`` so that any whole-number seed works, the molecules of
a batch grown side by side, and every batch of every seed holding the
same spread of sizes.
"""

import math

import numpy as np

MASS_H, MASS_HEAVY = 1.008, 12.011


def near_cubic_dims(n):
    """The factorisation ``n = nx * ny * nz`` closest to a cube."""
    best = None
    for nx in range(2, int(round(n ** (1 / 3))) + 9):
        if n % nx:
            continue
        m = n // nx
        for ny in range(2, int(np.sqrt(m)) + 2):
            if m % ny:
                continue
            nz = m // ny
            spread = max(nx, ny, nz) / min(nx, ny, nz)
            if best is None or spread < best[0]:
                best = (spread, (nx, ny, nz))
    return best[1]


def jittered_lattice(seed, atoms, density, elements, jitter):
    """``atoms`` on a near-cubic lattice filling a periodic cube at
    ``density`` (atoms / A^3), each moved by up to ``jitter`` of the
    lattice spacing along each axis, Z drawn from ``elements``.  Returns
    ``(z, pos, masses, box_length)``."""
    rng = np.random.default_rng(seed)
    length = (atoms / density) ** (1.0 / 3.0)
    dims = near_cubic_dims(atoms)
    grid = np.stack(np.meshgrid(*[np.arange(d) for d in dims],
                                indexing="ij"), -1).reshape(-1, 3) + 0.5
    a = length / np.array(dims, np.float64)
    pos = grid * a + rng.uniform(-jitter * a.min(), jitter * a.min(),
                                 (atoms, 3))
    z = rng.choice(np.asarray(elements), atoms)
    masses = np.where(z == 1, MASS_H, MASS_HEAVY)
    return z.astype(np.int64), pos.astype(np.float32), masses, length


def grow_molecules(rng, sizes, most, bond=(1.0, 1.6), floor=1.2, tries=16):
    """Molecules of ``sizes`` atoms, grown side by side as branched
    chains: each new atom ``bond`` A from one of the last four and at
    least ``floor`` A from every other of its molecule, and no atom with
    more than ``most = (cutoff, atoms)`` atoms (itself included) within
    ``cutoff`` (``tries`` candidates drawn at once, the first that fits
    taken; a molecule with none draws again, after ``tries`` rounds from
    any of its atoms).  Returns one ``[n, 3]`` array a molecule,
    centred."""
    sizes = np.asarray(sizes)
    m, top = len(sizes), int(sizes.max())
    cut2, cap = most[0] ** 2, most[1]
    pos = np.zeros((m, top, 3))
    count = np.zeros((m, top), np.int64)   # atoms within the cutoff
    count[:, 0] = 1
    for i in range(1, top):
        todo = np.flatnonzero(sizes > i)
        for rounds in range(tries * tries):
            if not len(todo):
                break
            v = rng.standard_normal((len(todo), tries, 3))
            v *= (rng.uniform(*bond, (len(todo), tries))
                  / np.linalg.norm(v, axis=-1))[..., None]
            back = 1 + rng.integers(4 if rounds < tries else i,
                                    size=len(todo))
            anchor = pos[todo, np.maximum(0, i - back)]
            cand = anchor[:, None, :] + v
            diff = cand[:, :, None] - pos[todo, None, :i]
            d2 = np.einsum("mtix,mtix->mti", diff, diff)
            near = d2 < cut2
            full = count[todo, None, :i] >= cap
            ok = ((d2.min(-1) >= floor ** 2) & (near.sum(-1) + 1 <= cap)
                  & ~(near & full).any(-1))
            hit = ok.any(1)
            first = ok.argmax(1)
            rows, picks = todo[hit], first[hit]
            pos[rows, i] = cand[hit, picks]
            grown = near[hit, picks]
            count[rows, :i] += grown
            count[rows, i] = grown.sum(-1) + 1
            todo = todo[~hit]
        if len(todo):
            raise RuntimeError(f"{len(todo)} molecules cannot grow atom {i}")
    return [p[:n] - p[:n].mean(0) for p, n in zip(pos, sizes)]


def molecule_batch(rng, n_mols, sizes, most, elements, probs, charges,
                   spacing):
    """``n_mols`` grown molecules, their sizes spread evenly from
    ``sizes[0]`` to ``sizes[1]`` atoms in an order drawn from ``rng`` (so
    that a seed changes the molecules and not the load), with at most
    ``most[1]`` atoms within ``most[0]`` A of any atom
    (:func:`grow_molecules`), Z from ``elements`` with ``probs``, total
    charges from ``charges``, ``spacing`` A apart on a grid.  Returns
    ``(z, pos, batch, q)``."""
    side = int(math.ceil(n_mols ** (1 / 3)))
    zs, ps, bs = [], [], []
    spread = np.rint(np.linspace(sizes[0], sizes[1], n_mols)).astype(int)
    grown = grow_molecules(rng, rng.permutation(spread), most)
    for m, p in enumerate(grown):
        cell = np.array([m % side, m // side % side, m // side ** 2])
        ps.append(p + spacing * cell)
        zs.append(rng.choice(np.asarray(elements), len(p), p=probs))
        bs.append(np.full(len(p), m))
    q = rng.choice(np.asarray(charges, np.float32), n_mols)
    return (np.concatenate(zs).astype(np.int64),
            np.concatenate(ps).astype(np.float32),
            np.concatenate(bs).astype(np.int64), q.astype(np.float32))
