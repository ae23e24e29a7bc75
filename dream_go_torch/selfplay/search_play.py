"""Full-search self-play with continuous batching.

Port of `dream_go_tpu/selfplay/search_play.py` (``_finish_move``,
``_build_search_move_fn``, ``_reset_slots``,
``search_self_play_continuous``).  All games of the batch move in lockstep:
every move is one batched search (`mcts.search`) and one batched board
step; every ``refill_every`` moves finished games are flushed as SGF lines
and their slots restart with fresh boards and fresh trees.  Reference
semantics kept:

- passing is forbidden until a game is scorable: ScoringSearch masks apply
  in the tree for those games (`self_play.rs:434-436`);
- temperature sampling over visit counts for the first
  ``temperature_moves`` moves, LCB-greedy afterwards;
- per-player winrate-scaled rollout budgets: ``clamp(4*w*(1-w), 0.1, 1)
  * num_rollout`` simulations per move, ``w`` a moving average of the
  player's search values (momentum 0.2, `self_play.rs:218-241`);
- reused subtree visits count toward the budget.

Random draws (Dirichlet noise, temperature sampling) come from one
``torch.Generator`` on the search device, seeded by ``seed``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SearchConfig, SelfPlayConfig
from ..go import benson as bn
from ..go import engine
from ..mcts import search as S
from .policy import _final_territory, random_komi
from .records import Played, game_result_sgf


def _finish_move(search_cfg: SearchConfig, temperature_moves: int,
                 states: engine.GoState, trees: S.Tree,
                 gen: torch.Generator):
    """Pick moves from searched trees and step the boards."""
    temp = torch.where(states.move_count < temperature_moves,
                       float(search_cfg.temperature), 0.0)
    move, value = S.best_move(trees, gen, search_cfg, temp)
    move = torch.where(states.done, engine.PASS, move)
    targets = S.softmax_targets(trees)
    new_states = engine.step(states, move)
    return new_states, trees, move, value, targets


def _build_search_move_fn(predictor, search_cfg: SearchConfig,
                          num_sims: int, temperature_moves: int):
    """The first move searches fresh trees; later moves re-root the
    previous move's trees (`tree.rs:1225-1249`).  With ``reuse_budget`` a
    capacity of ``num_sims + 8`` always suffices (a subtree's node count
    never exceeds its root's visits)."""
    capacity = num_sims + 8 if search_cfg.reuse_budget else 2 * num_sims + 8

    def first_move_fn(states, gen, budget):
        use_scoring = ~bn.is_scorable(states) & ~states.done
        trees = S.search(states, predictor, gen, search_cfg, num_sims,
                         use_scoring, capacity=capacity,
                         adaptive=bool(search_cfg.adaptive), budget=budget)
        return _finish_move(search_cfg, temperature_moves, states, trees,
                            gen)

    def reuse_move_fn(states, trees, prev_move, gen, budget, fresh_mask):
        use_scoring = ~bn.is_scorable(states) & ~states.done
        trees = S.search_with_reuse(
            states, trees, prev_move, predictor, gen, search_cfg, num_sims,
            use_scoring, budget=budget, fresh_mask=fresh_mask,
            adaptive=bool(search_cfg.adaptive))
        return _finish_move(search_cfg, temperature_moves, states, trees,
                            gen)

    return first_move_fn, reuse_move_fn


def _reset_slots(states: engine.GoState, mask: torch.Tensor,
                 new_komi: torch.Tensor, history_len: int) -> engine.GoState:
    """Replace the masked slots with fresh boards (continuous refill)."""
    fresh = engine.new_states(states.batch, komi=0.0,
                              history_len=history_len,
                              device=states.stones.device)
    return fresh.replace(komi=new_komi).select(mask, states)


def search_self_play_continuous(predictor, cfg: SelfPlayConfig,
                                search_cfg: SearchConfig | None = None,
                                seed: int = 0, batch: int = 256,
                                refill_every: int = 8,
                                stats: dict | None = None,
                                device="cuda") -> list[str]:
    """Full-search self-play with continuous batching; returns the SGF
    lines of the first ``cfg.num_games`` completed games.

    ``stats`` receives ``move_events``, one ``(monotonic_time,
    active_games, charged_sims)`` tuple per move, appended after the move's
    results reach the host.
    """
    search_cfg = search_cfg or SearchConfig()
    dev = torch.device(device)
    rng_np = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    komi0 = random_komi(batch, seed) if cfg.random_komi \
        else np.full(batch, cfg.komi, np.float32)
    states = engine.new_states(batch, komi=cfg.komi,
                               history_len=cfg.history_len, device=dev)
    states = states.replace(komi=torch.as_tensor(komi0, device=dev))
    first_fn, reuse_fn = _build_search_move_fn(
        predictor, search_cfg, cfg.num_rollout, cfg.temperature_moves)

    winrate = np.full((batch, 2), 0.5, np.float32)
    rows = np.arange(batch)
    records = []                 # time-major
    rec_base = 0                 # global index of records[0]
    episode_start = np.zeros(batch, np.int64)
    fresh_mask = np.zeros(batch, bool)
    games: list[str] = []
    trees, prev_move = None, None
    move_i = 0
    max_total = cfg.max_moves * (cfg.num_games + batch)

    def flush_and_refill():
        nonlocal states, records, rec_base
        done = (states.done | (states.move_count >= cfg.max_moves)) \
            .cpu().numpy()
        if not done.any():
            return
        territory = _final_territory(states).cpu().numpy()
        komis = states.komi.cpu().numpy()
        for g in np.flatnonzero(done):
            sgf_moves = []
            for rec in records[int(episode_start[g]) - rec_base:]:
                active, move, value, to_move, targets, budget = rec
                if not active[g]:
                    break
                sgf_moves.append(Played(
                    to_move=int(to_move[g]), point=int(move[g]),
                    value=float(value[g]), num_rollout=int(budget[g]),
                    softmax=targets[g]).to_sgf())
            games.append(game_result_sgf(
                "".join(sgf_moves), komi=float(komis[g]),
                territory=territory[g]))
        refill_komi = np.where(
            done,
            random_komi(batch, int(rng_np.integers(1, 2**31)))
            if cfg.random_komi else np.full(batch, cfg.komi, np.float32),
            komis).astype(np.float32)
        states = _reset_slots(states, torch.as_tensor(done, device=dev),
                              torch.as_tensor(refill_komi, device=dev),
                              cfg.history_len)
        winrate[done] = 0.5
        episode_start[done] = rec_base + len(records)
        fresh_mask[done] = True
        lo = int(episode_start.min())
        if lo > rec_base:
            records = records[lo - rec_base:]
            rec_base = lo

    while len(games) < cfg.num_games and move_i < max_total:
        active = ~states.done.cpu().numpy()
        to_move = states.to_move.cpu().numpy()
        if cfg.winrate_rollouts:
            w = winrate[rows, np.maximum(to_move, 1) - 1]
            m = np.maximum(4.0 * w * (1.0 - w), 0.1)
            budget = (m * cfg.num_rollout).astype(np.int32)
        else:
            budget = np.full(batch, cfg.num_rollout, np.int32)
        dbudget = torch.as_tensor(budget, device=dev)
        if trees is None:
            states, trees, move, value, targets = first_fn(
                states, gen, dbudget)
        else:
            states, trees, move, value, targets = reuse_fn(
                states, trees, prev_move, gen, dbudget,
                torch.as_tensor(fresh_mask, device=dev))
        fresh_mask[:] = False
        prev_move = move
        value = value.cpu().numpy()
        if stats is not None:
            stats.setdefault("move_events", []).append(
                (time.monotonic(), int(active.sum()),
                 int(budget[active].sum()) if active.any() else 0))
        if cfg.winrate_rollouts:
            col = np.maximum(to_move, 1) - 1
            upd = winrate[rows, col] - cfg.winrate_momentum * (
                winrate[rows, col] - value)
            winrate[rows, col] = np.where(active, upd, winrate[rows, col])
        records.append((active, move.cpu().numpy(), value, to_move,
                        targets.cpu().numpy().astype(np.float16), budget))
        move_i += 1
        if move_i % refill_every == 0:
            flush_and_refill()

    return games[:cfg.num_games]
