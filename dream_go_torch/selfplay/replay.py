"""Replay recorded games to recover board states at given positions (port
of `dream_go_tpu/selfplay/replay.py`).

Ex-it, reanalyze and the training input pipeline replay games in lockstep:
one batched :func:`engine.step` a move for all games (JAX's ``lax.scan``
becomes a host loop), keeping each game's state *before* its target move.
A target equal to the padded length ``T`` asks for the final position.
The loop stops at the largest target when no game asks for the final
position; the states it keeps are the same.
"""

from __future__ import annotations

import torch

from ..go import engine
from ..go.engine import GoState


def _where(mask: torch.Tensor, new: GoState, old: GoState) -> GoState:
    """Fieldwise ``where(mask, new, old)``; ``mask`` spans the leading
    axes of ``old``, ``new`` broadcasts against it."""
    out = {}
    for name, o in old.fields().items():
        m = mask.reshape(mask.shape + (1,) * (o.dim() - mask.dim()))
        out[name] = torch.where(m, getattr(new, name), o)
    return GoState(**out)


def _initial(komi: torch.Tensor, history_len: int) -> GoState:
    return engine.new_states(komi.shape[0], 0.0, history_len,
                             device=komi.device).replace(
        komi=komi.to(torch.float32))


def _last_step(target_idx: torch.Tensor, t_max: int) -> int:
    """How many moves to replay: all of them when a game asks for the
    final position, else up to the largest target."""
    if target_idx.numel() == 0 or bool((target_idx == t_max).any()):
        return t_max
    return max(0, min(t_max, int(target_idx.max())))


def states_at(moves: torch.Tensor, target_idx: torch.Tensor,
              komi: torch.Tensor, history_len: int = 64) -> GoState:
    """States before move ``target_idx`` per game.

    ``moves``: int32[G, T] actions padded with PASS; ``target_idx``:
    int32[G] (0 = initial position, T = final position); ``komi``: f32[G].
    """
    t_max = moves.shape[1]
    states = saved = _initial(komi, history_len)
    last = _last_step(target_idx, t_max)
    for t in range(last):
        saved = _where(target_idx == t, states, saved)
        states = engine.step(states, moves[:, t])
    return _where(target_idx == last, states, saved)


def final_states(moves: torch.Tensor, lengths: torch.Tensor,
                 komi: torch.Tensor, history_len: int = 64) -> GoState:
    """States after each game's full move sequence."""
    return states_at(moves, lengths, komi, history_len)


def states_at_multi(moves: torch.Tensor, target_idx: torch.Tensor,
                    komi: torch.Tensor, history_len: int = 64) -> GoState:
    """States before ``target_idx[g, j]`` for K positions a game, from one
    replay: fields with leading axes [G, K]."""
    g, t_max = moves.shape
    k = target_idx.shape[1]
    states = _initial(komi, history_len)
    saved = GoState(**{name: v[:, None].expand((g, k) + v.shape[1:])
                       for name, v in states.fields().items()})

    def widen(st):
        return GoState(**{name: v[:, None] for name, v in st.fields().items()})

    last = _last_step(target_idx, t_max)
    for t in range(last):
        saved = _where(target_idx == t, widen(states), saved)
        states = engine.step(states, moves[:, t])
    return _where(target_idx == last, widen(states), saved)


def states_and_stone_history_at(moves: torch.Tensor,
                                target_idx: torch.Tensor,
                                komi: torch.Tensor, history_len: int = 64,
                                depth: int = 8):
    """Like :func:`states_at`, and also the last ``depth`` stone snapshots
    up to the target, most recent first: int8[G, depth, 361] (index 0 =
    the returned position), for leela-zero history features
    (`features.rs:398-470`)."""
    g, t_max = moves.shape
    states = saved = _initial(komi, history_len)
    hist = saved_hist = torch.zeros(g, depth, engine.NN, dtype=torch.int8,
                                    device=moves.device)
    last = _last_step(target_idx, t_max)
    for t in range(last + 1):
        hist = torch.cat([states.stones[:, None], hist[:, :-1]], 1)
        now = (target_idx == t)
        saved_hist = torch.where(now[:, None, None], hist, saved_hist)
        saved = _where(now, states, saved)
        if t < last:
            states = engine.step(states, moves[:, t])
    return saved, saved_hist


def lz_features(states: GoState, stone_history: torch.Tensor) -> torch.Tensor:
    """f32[B, 19, 19, 18] leela-zero input planes (`features.rs:398-470`)
    from :func:`states_and_stone_history_at`'s snapshots (index 0 = the
    current position): planes 0-7 the to-move player's stones over the last
    eight positions, 8-15 the opponent's, 16/17 all ones when black / white
    is to move."""
    me = states.to_move[:, None, None]
    hist = stone_history.to(torch.int8)                     # [B, 8, 361]
    own = (hist == me).to(torch.float32)
    opp = (hist == (3 - me.to(torch.int32)).to(torch.int8)).to(torch.float32)
    is_black = (states.to_move == engine.BLACK).to(torch.float32)
    ones = torch.ones(hist.shape[0], 1, engine.NN, device=hist.device)
    planes = torch.cat([own, opp, ones * is_black[:, None, None],
                        ones * (1.0 - is_black)[:, None, None]], 1)
    return planes.transpose(1, 2).reshape(-1, 19, 19, 18)
