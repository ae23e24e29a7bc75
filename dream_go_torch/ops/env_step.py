"""One environment step per board: legality with positional super-ko, a
weighted move sample, and the board update.

Replaces the Pallas TPU kernel `dream_go_tpu/ops/env_step.py::env_step`
(``_kernel``) with a CUDA kernel written for Hopper, ``csrc/env_step.cu``
(a block of four warps per board, its point sets as bitboards, liberties
saturated at two, a ring filter for super-ko, Philox once per counter,
the move derived by every thread), built with ``nvcc`` and bound with
``ctypes`` (:mod:`dream_go_torch.ops.build`).  :func:`env_step_checked`
launches the kernel's bounds-checked build (``-DDG_CHECK``), whose
device-side asserts trap on an index out of range.

Per board the move is a Gumbel argmax: with a 32-bit random word per
point, ``u = (word >> 8) * 2**-24`` clipped to ``[1e-7, 1 - 1e-7]``, the
score ``log(max(w, 0) + 1e-30) - log(-log(u))`` at legal points with a
positive weight ``w`` and ``-inf`` elsewhere; the first index of the
largest score wins, and a board with no finite score (or a finished one)
passes.  Uniform weights give a uniform random legal move; a one-hot
weight plays that point if it is legal and passes otherwise.

Random words.  ``rng_bits`` (int32[B, 361] bit patterns) gives them
directly: the JAX kernel's ``use_prng=False`` path, and the two agree bit
for bit.  Without it the words come from Philox-4x32-10 (the Random123
constants): key ``(seed, b)`` for board ``b`` of the call, counter
``(move_count, q // 4, 0, 0)``, word ``q % 4`` for padded point ``q`` (96
calls of four words per board).  It stands in for the TPU core's
generator, seeded with ``seed + b * 7919 + move_count * 65537``
(`dream_go_tpu/ops/env_step.py:167-171`), whose stream a GPU cannot
reproduce: the two modes draw from the same distribution with different
numbers.  :func:`philox_bits` computes the words in PyTorch, so the plain
version and the kernel agree bit for bit in this mode too.

Inputs are the kernel-layout state arrays of :mod:`ops.layout`;
``weights`` float32[B, 361]; ``seed`` a 32-bit integer.  Returns
``(new_rows, moves)``: the six arrays of the new position and int32[B]
moves (361 = pass, also for a finished board).  :func:`env_step_states`
is the same step on a ``GoState``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..go import engine
from ..go.engine import GoState
from ..go.topology import NN
from . import build, layout
from .layout import NP, RING

#: kernel launches made by :func:`env_step` (CPU calls do not count)
launches = 0

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` 32-bit words of ``m * x`` for int64 tensors holding
    unsigned 32-bit values, from 16-bit limbs (the full product does not
    fit in a signed 64-bit integer)."""
    m_lo, m_hi = m & 0xFFFF, m >> 16
    x_lo, x_hi = x & 0xFFFF, x >> 16
    ll, lh, hl = x_lo * m_lo, x_lo * m_hi, x_hi * m_lo
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = x_hi * m_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox-4x32-10 on int64 tensors holding unsigned 32-bit words:
    ``ctr`` four tensors, ``key`` two; returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed: int, move_count: torch.Tensor) -> torch.Tensor:
    """int32[B, 361] random words of the kernel's Philox mode (see module
    docstring) for boards at ``move_count`` (int32[B])."""
    dev = move_count.device
    b = move_count.shape[0]
    i64 = dict(dtype=torch.int64, device=dev)
    shape = (b, NP // 4)
    ctr = (move_count.to(torch.int64)[:, None].expand(shape) & _MASK32,
           torch.arange(NP // 4, **i64)[None, :].expand(shape),
           torch.zeros(shape, **i64), torch.zeros(shape, **i64))
    key = (torch.full(shape, int(seed) & _MASK32, **i64),
           torch.arange(b, **i64)[:, None].expand(shape))
    words = torch.stack(philox4x32_10(ctr, key), dim=2).reshape(b, NP)
    # unsigned words as int32 bit patterns
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words[:, :NN].to(torch.int32)


def gumbel_scores(legal, weights, bits) -> torch.Tensor:
    """float32[B, 361] sampling scores: the Gumbel value of each word plus
    ``log`` of the clamped weight at legal points with a positive weight,
    ``-inf`` elsewhere (the kernel's order of operations)."""
    word = bits.to(torch.int64) & _MASK32
    u = (word >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u = torch.clamp(u, 1e-7, 1.0 - 1e-7)
    gumbel = -torch.log(-torch.log(u))
    w = torch.clamp(weights, min=0.0)
    return torch.where(legal & (w > 0), torch.log(w + 1e-30) + gumbel,
                       float("-inf"))


def env_step_plain(stones, cid, cxp, hist, meta, hashw, weights, seed,
                   rng_bits=None):
    """Plain PyTorch version of the kernel (same inputs and outputs): the
    rules engine's legality and step around :func:`gumbel_scores`."""
    b = stones.shape[0]
    template = engine.new_states(b, device=stones.device)
    state = layout.unpack_states(template, stones, cid, cxp, hist, meta,
                                 hashw)
    legal = engine.legal_mask(state)[:, :NN]
    bits = philox_bits(seed, meta[:, 0, 2]) if rng_bits is None \
        else rng_bits
    score = gumbel_scores(legal, weights, bits)
    is_pass = ~(score > float("-inf")).any(1) | state.done
    move = torch.where(is_pass, NN, torch.argmax(score, 1)).to(torch.int32)
    new = engine.step(state, move)
    return layout.repack_rows(new, stones, cid, cxp, hist, meta,
                              hashw), move


@functools.lru_cache(maxsize=None)
def _kernel(check: bool):
    fn = build.load("env_step", check).dg_env_step
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_uint32]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def env_step(stones, cid, cxp, hist, meta, hashw, weights, seed,
             rng_bits=None):
    """One step per board (see module docstring).  CPU tensors take
    :func:`env_step_plain`; CUDA tensors launch the kernel on the current
    stream."""
    return _step(stones, cid, cxp, hist, meta, hashw, weights, seed,
                 rng_bits, check=False)


def env_step_checked(stones, cid, cxp, hist, meta, hashw, weights, seed,
                     rng_bits=None):
    """:func:`env_step` with the kernel's bounds-checked build: an index
    out of range traps, and the next synchronisation raises."""
    return _step(stones, cid, cxp, hist, meta, hashw, weights, seed,
                 rng_bits, check=True)


def _step(stones, cid, cxp, hist, meta, hashw, weights, seed, rng_bits,
          check: bool):
    global launches
    if stones.device.type == "cpu":
        return env_step_plain(stones, cid, cxp, hist, meta, hashw, weights,
                              seed, rng_bits)
    if stones.device.type != "cuda":
        raise ValueError(f"env_step: unsupported device {stones.device}")
    dev = stones.device
    b = stones.shape[0]
    state = dict(stones=stones, cid=cid, cxp=cxp, hist=hist, meta=meta,
                 hashw=hashw)
    for name, t in state.items():
        build.check_arg("env_step", name, t, torch.int32,
                        (b,) + layout.ROW_SHAPES[name], dev)
    build.check_arg("env_step", "weights", weights, torch.float32, (b, NN),
                    dev)
    if rng_bits is not None:
        build.check_arg("env_step", "rng_bits", rng_bits, torch.int32,
                        (b, NN), dev)
    outs = [torch.empty_like(t) for t in state.values()]
    move = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return tuple(outs), move
    zob = layout.zobrist_rows(str(dev))
    bits_ptr = None if rng_bits is None else rng_bits.data_ptr()
    build.launch("env_step", _kernel(check), dev,
                 *[t.data_ptr() for t in state.values()],
                 weights.data_ptr(), bits_ptr, int(seed) & 0xFFFFFFFF,
                 zob.data_ptr(), *[t.data_ptr() for t in outs],
                 move.data_ptr(), b)
    launches += 1
    return tuple(outs), move


def env_step_states(states: GoState, weights, seed,
                    rng_bits=None) -> tuple[GoState, torch.Tensor]:
    """:func:`env_step` on a batched ``GoState``: returns ``(new_states,
    moves)``.  ``chain_xor`` is zero at the empty points of the result, as
    the layout packs it (`dream_go_tpu/ops/env_step.py:301-351`).  The
    super-ko ring must hold 64 entries, as the kernel's does."""
    if states.hash_hist.shape[1] != RING:
        raise ValueError(f"env_step: the super-ko ring holds "
                         f"{states.hash_hist.shape[1]} entries, not {RING}")
    rows, move = env_step(*layout.pack_states(states), weights, seed,
                          rng_bits)
    return layout.unpack_states(states, *rows), move
