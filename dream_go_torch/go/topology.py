"""Static board topology: neighbour tables and D8 symmetry permutations.

Port of `dream_go_tpu/go/topology.py`, rebuilt here so the port never
imports the JAX package.  Off-board neighbours use the sentinel index
``NN`` (= 361).
"""

from __future__ import annotations

import numpy as np

N = 19
NN = N * N
PASS = NN


def _build_neighbors() -> np.ndarray:
    nbr = np.full((NN, 4), NN, dtype=np.int32)
    for p in range(NN):
        x, y = p % N, p // N
        for k, (dx, dy) in enumerate(((0, -1), (-1, 0), (1, 0), (0, 1))):
            nx, ny = x + dx, y + dy
            if 0 <= nx < N and 0 <= ny < N:
                nbr[p, k] = N * ny + nx
    return nbr


#: [361, 4] neighbour indices (up, left, right, down); NN for off-board.
NBR: np.ndarray = _build_neighbors()

#: [361] iota.
IOTA: np.ndarray = np.arange(NN, dtype=np.int32)


def _build_neighbors8() -> np.ndarray:
    """[361, 8]: 4 cross then 4 diagonal neighbours; NN for off-board."""
    nbr = np.full((NN, 8), NN, dtype=np.int32)
    offsets = ((1, 0), (-1, 0), (0, 1), (0, -1),
               (1, 1), (1, -1), (-1, 1), (-1, -1))
    for p in range(NN):
        x, y = p % N, p // N
        for k, (dx, dy) in enumerate(offsets):
            nx, ny = x + dx, y + dy
            if 0 <= nx < N and 0 <= ny < N:
                nbr[p, k] = N * ny + nx
    return nbr


#: [361, 8] cross+diagonal neighbours (eye heuristic).
NBR8: np.ndarray = _build_neighbors8()


def _build_symmetries() -> np.ndarray:
    """D8 gather permutations, ``SYM[t][dst] = src`` (`symmetry.rs:67-78`
    order: identity, flipLR, flipUD, transpose, anti-transpose, rot90,
    rot180, rot270)."""
    def idx(fn):
        out = np.empty(NN, dtype=np.int32)
        for dst in range(NN):
            x, y = dst % N, dst // N
            sx, sy = fn(x, y)
            out[dst] = N * sy + sx
        return out

    c = N - 1
    return np.stack([
        idx(lambda x, y: (x, y)),
        idx(lambda x, y: (c - x, y)),
        idx(lambda x, y: (x, c - y)),
        idx(lambda x, y: (y, x)),
        idx(lambda x, y: (c - y, c - x)),
        idx(lambda x, y: (y, c - x)),
        idx(lambda x, y: (c - x, c - y)),
        idx(lambda x, y: (c - y, x)),
    ])


SYM: np.ndarray = _build_symmetries()


def _invert(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


SYM_INV: np.ndarray = np.stack([_invert(SYM[t]) for t in range(8)])
SYM_POLICY: np.ndarray = np.concatenate(
    [SYM, np.full((8, 1), PASS, dtype=np.int32)], axis=1)
SYM_POLICY_INV: np.ndarray = np.concatenate(
    [SYM_INV, np.full((8, 1), PASS, dtype=np.int32)], axis=1)
