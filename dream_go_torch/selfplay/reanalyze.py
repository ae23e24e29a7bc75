"""Reanalyze and ex-it annotation: re-search recorded positions in batches
(port of `dream_go_tpu/selfplay/reanalyze.py`).

Replaces `src/libdg_mcts/reanalyze.rs` and the ex-it arm of
`self_play.rs:287-319`.  Both take SGF lines, pick a subset of positions,
re-search them with fresh trees (batched across positions), and re-emit
the lines with new ``TV[n]P[...]V[...]`` annotations on those moves:

- reanalyze: ~5% of all positions, uniformly at random
  (`reanalyze.rs:98-104`);
- ex-it: ~5% of the positions whose recorded to-move win rate is at most
  0.8 (`self_play.rs:315-319` ``is_good_candidate``).

The positions are drawn from ``np.random.default_rng(seed)`` in the order
of the JAX package, so both pick the same ones; the search's own draws
(Dirichlet noise) come from a ``torch.Generator`` and differ from JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SearchConfig
from ..go import engine
from ..mcts import search as S
from ..utils import sgf
from .records import Played, game_result_sgf
from .replay import states_at


def _search_positions(states, predictor, search_cfg: SearchConfig,
                      num_sims: int, seed: int):
    """Fresh-tree search of one chunk of positions -> (targets f16[B, 362],
    values f32[B]): the visit distribution, and the value of the most
    visited root child."""
    gen = torch.Generator(device=states.stones.device).manual_seed(seed)
    trees = S.search(states, predictor, gen, search_cfg, num_sims, None,
                     adaptive=bool(search_cfg.adaptive))
    targets = S.softmax_targets(trees).cpu().numpy().astype(np.float16)
    q = S.root_q(trees).cpu().numpy()
    visits = S.root_visits(trees).cpu().numpy()
    best = visits.argmax(axis=-1)
    return targets, q[np.arange(q.shape[0]), best]


def annotate_lines(lines: list[str], predictor,
                   search_cfg: SearchConfig | None = None,
                   num_sims: int = 100, fraction: float = 0.05,
                   max_value: float | None = None, seed: int = 0,
                   position_batch: int = 64, device="cuda") -> list[str]:
    """Re-search the selected positions and patch their SGF annotations.
    The last chunk is padded to ``position_batch`` with its last
    position."""
    dev = torch.device(device)
    search_cfg = (search_cfg or SearchConfig()).resolve_auto(dev)
    rng = np.random.default_rng(seed)

    parsed = [sgf.parse_line(line) for line in lines]
    candidates: list[tuple[int, int]] = []
    for gi, game in enumerate(parsed):
        if game is None:
            continue
        for mi, mv in enumerate(game.moves):
            if max_value is not None and mv.value is not None:
                wr = (mv.value + 1.0) / 2.0  # V[] is black-perspective
                if mv.color == 2:
                    wr = 1.0 - wr
                if wr > max_value:
                    continue
            if rng.random() < fraction:
                candidates.append((gi, mi))
    if not candidates:
        return list(lines)

    new_annotations: dict[tuple[int, int], tuple[np.ndarray, float]] = {}
    for start in range(0, len(candidates), position_batch):
        chunk = candidates[start:start + position_batch]
        chunk_p = chunk + [chunk[-1]] * (position_batch - len(chunk))
        t_max = max(len(parsed[g].moves) for g, _ in chunk_p)
        moves = np.full((position_batch, t_max), engine.PASS, np.int32)
        komi = np.zeros(position_batch, np.float32)
        tgt = np.zeros(position_batch, np.int32)
        for row, (g, mi) in enumerate(chunk_p):
            seq = [mv.point for mv in parsed[g].moves]
            moves[row, :len(seq)] = seq
            komi[row] = parsed[g].komi
            tgt[row] = mi
        states = states_at(torch.from_numpy(moves).to(dev),
                           torch.from_numpy(tgt).to(dev),
                           torch.from_numpy(komi).to(dev), 64)
        targets, values = _search_positions(states, predictor, search_cfg,
                                            num_sims, seed + start)
        for row, (g, mi) in enumerate(chunk):
            new_annotations[(g, mi)] = (targets[row], float(values[row]))

    out = []
    for gi, (line, game) in enumerate(zip(lines, parsed)):
        if game is None:
            out.append(line)
            continue
        sgf_moves = []
        for mi, mv in enumerate(game.moves):
            if (gi, mi) in new_annotations:
                tgts, val = new_annotations[(gi, mi)]
                sgf_moves.append(Played(
                    to_move=mv.color, point=mv.point, value=val,
                    num_rollout=num_sims, softmax=tgts).to_sgf())
            else:
                black_value = mv.value
                tm_value = None
                if black_value is not None:
                    tm_value = (black_value + 1.0) / 2.0 if mv.color == 1 \
                        else (1.0 - black_value) / 2.0
                sgf_moves.append(Played(
                    to_move=mv.color, point=mv.point, value=tm_value,
                    num_rollout=mv.num_rollout or 1,
                    softmax=mv.policy).to_sgf())
        terr = np.zeros(361, np.int8)
        terr[game.black_territory] = 1
        terr[game.white_territory] = 2
        out.append(game_result_sgf("".join(sgf_moves), komi=game.komi,
                                   territory=terr if terr.any() else None,
                                   resign_winner=game.winner
                                   if game.by_resign else None))
    return out


def reanalyze(lines: list[str], predictor,
              search_cfg: SearchConfig | None = None, num_sims: int = 100,
              fraction: float = 0.05, seed: int = 0,
              position_batch: int = 64, device="cuda") -> list[str]:
    """``--reanalyze``: refresh ~5% of positions with new search
    annotations."""
    return annotate_lines(lines, predictor, search_cfg, num_sims,
                          fraction=fraction, max_value=None, seed=seed,
                          position_batch=position_batch, device=device)


def ex_it(lines: list[str], predictor,
          search_cfg: SearchConfig | None = None, num_sims: int = 100,
          fraction: float = 0.05, seed: int = 0,
          position_batch: int = 64, device="cuda") -> list[str]:
    """``--ex-it``: expert-iteration annotation of mid-value positions."""
    return annotate_lines(lines, predictor, search_cfg, num_sims,
                          fraction=fraction, max_value=0.8, seed=seed,
                          position_batch=position_batch, device=device)
