"""Zobrist hashing table for positional super-ko.

Port of `dream_go_tpu/go/zobrist.py`: the same seeded PCG64 table, so both
packages hash every position identically.  The port carries each 64-bit
hash as two int32 bit patterns (torch has no full uint32 arithmetic on the
CPU); all hash arithmetic is XOR, which is indifferent to the sign bit.
"""

from __future__ import annotations

import numpy as np

from .topology import NN

_SEED = 0x20260816


def _build_table() -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(_SEED))
    return rng.integers(0, 2**32, size=(2, NN, 2), dtype=np.uint32)


#: [2, 361, 2] uint32 zobrist entries: [color-1, point, hash-word].
Z: np.ndarray = _build_table()

#: The same table as int32 bit patterns (what the tensors carry).
Z_I32: np.ndarray = Z.view(np.int32)
