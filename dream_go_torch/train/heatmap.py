"""Board heat-map rendering for training observability (port of
`dream_go_tpu/train/heatmap.py`).

Replaces the reference's TensorBoard op ``tensor_to_heat_image``
(`contrib/trainer/libdg_tf/tensor_to_image.cc:297-308`): a 19x19 board
with its stones over a per-point heat map (ownership, policy, ...) as an
RGB image, for tools and debugging.  :func:`save_heat_image` writes the
PNG with the standard library (``zlib``, ``struct``), so it needs no
imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_CELL = 16


def heat_image(stones: np.ndarray, heat: np.ndarray | None = None
               ) -> np.ndarray:
    """uint8[H, W, 3] image of the board with an optional heat overlay.

    ``stones``: int[361] 0/1/2; ``heat``: float[361] in [-1, 1] (blue
    negative, red positive) or [0, 1] (red scale).
    """
    stones = np.asarray(stones).reshape(19, 19)
    img = np.full((19 * _CELL, 19 * _CELL, 3), 219, np.uint8)
    img[..., 0] = 222  # board-ish background
    img[..., 1] = 184
    img[..., 2] = 135

    if heat is not None:
        h = np.clip(np.asarray(heat, np.float32).reshape(19, 19), -1.0, 1.0)
        for y in range(19):
            for x in range(19):
                v = h[y, x]
                if v == 0:
                    continue
                sl = (slice(y * _CELL, (y + 1) * _CELL),
                      slice(x * _CELL, (x + 1) * _CELL))
                base = img[sl].astype(np.float32)
                color = np.asarray([255, 40, 40] if v > 0 else [40, 40, 255],
                                   np.float32)
                img[sl] = (base * (1 - abs(v)) + color * abs(v)) \
                    .astype(np.uint8)

    # grid lines
    for i in range(19):
        c = i * _CELL + _CELL // 2
        img[c, _CELL // 2:19 * _CELL - _CELL // 2] //= 2
        img[_CELL // 2:19 * _CELL - _CELL // 2, c] //= 2

    # stones
    yy, xx = np.mgrid[0:_CELL, 0:_CELL]
    disc = (yy - _CELL / 2 + 0.5) ** 2 + (xx - _CELL / 2 + 0.5) ** 2 \
        <= (_CELL / 2 - 1) ** 2
    for y in range(19):
        for x in range(19):
            if stones[y, x] == 0:
                continue
            sl = (slice(y * _CELL, (y + 1) * _CELL),
                  slice(x * _CELL, (x + 1) * _CELL))
            region = img[sl]
            region[disc] = 20 if stones[y, x] == 1 else 245
            img[sl] = region
    return img


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img`` (uint8[H, W, 3]): signature, IHDR, one
    zlib IDAT of filter-0 rows, IEND."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9))
            + chunk(b"IEND", b""))


def save_heat_image(path: str, stones, heat=None):
    with open(path, "wb") as fh:
        fh.write(png_bytes(heat_image(stones, heat)))
