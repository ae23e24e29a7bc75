"""Git-style base85 codec for tensor payloads (port of
`dream_go_tpu/utils/b85.py`, `src/libdg_utils/b85.rs`): the little-endian
bytes of a tensor, 4-byte words as 5 digits of the RFC-1924 alphabet, which
is :func:`base64.b85encode`.  Used by the weights JSON and by the policy
blobs of self-play SGF records."""

from __future__ import annotations

import base64

import numpy as np


def encode(array: np.ndarray) -> str:
    """Encode an array; float inputs are narrowed to f16 first
    (`b85.rs:141-165`)."""
    array = np.asarray(array)
    if array.dtype == np.float32 or array.dtype == np.float64:
        array = array.astype(np.float16)
    data = array.tobytes()
    if len(data) % 4 != 0:
        raise ValueError(f"b85 payload must be a multiple of 4 bytes, "
                         f"got {len(data)}")
    return base64.b85encode(data).decode("ascii")


def decode(text: str, dtype=np.float16) -> np.ndarray:
    """Decode a base85 string into an array of ``dtype``."""
    data = base64.b85decode(text.encode("ascii"))
    return np.frombuffer(data, dtype=dtype).copy()
