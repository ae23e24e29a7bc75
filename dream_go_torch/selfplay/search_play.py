"""Full-search self-play with continuous batching.

Port of `dream_go_tpu/selfplay/search_play.py` (``_finish_move``,
``_build_search_move_fn``, ``_reset_slots``, ``search_self_play``,
``_policy_stagger``, ``search_self_play_continuous``).  All games of the
batch move in lockstep: every move is one batched search (`mcts.search`)
and one batched board step.  ``search_self_play`` plays one batch until
its last game ends; ``search_self_play_continuous`` flushes finished games
as SGF lines every ``refill_every`` moves and restarts their slots with
fresh boards and fresh trees.  Reference semantics kept:

- passing is forbidden until a game is scorable: ScoringSearch masks apply
  in the tree for those games (`self_play.rs:434-436`);
- temperature sampling over visit counts for the first
  ``temperature_moves`` moves, LCB-greedy afterwards;
- per-player winrate-scaled rollout budgets: ``clamp(4*w*(1-w), 0.1, 1)
  * num_rollout`` simulations per move, ``w`` a moving average of the
  player's search values (momentum 0.2, `self_play.rs:218-241`);
- reused subtree visits count toward the budget.

Random draws (Dirichlet noise, temperature sampling) come from one
``torch.Generator`` on the search device, seeded by ``seed``.  With a
``mesh`` each rank plays its share of the batch with its rows of the
whole batch's draws (:mod:`..utils.draws`), as policy play does, and the
lines are gathered.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SearchConfig, SelfPlayConfig
from ..go import benson as bn
from ..go import engine
from ..mcts import search as S
from ..mcts.predictor import symmetrize
from ..utils.draws import batch_rows
from .policy import PolicyPlayer, _build_move_fn, _final_territory, random_komi
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
                          num_sims: int, temperature_moves: int,
                          tree_reuse: bool = True):
    """The first move searches fresh trees; later moves re-root the
    previous move's trees (`tree.rs:1225-1249`).  With ``reuse_budget`` a
    capacity of ``num_sims + 8`` always suffices (a subtree's node count
    never exceeds its root's visits).  Without ``tree_reuse`` every move
    searches fresh trees and the second function is None.
    ``search_cfg.max_nodes`` overrides either capacity."""
    if search_cfg.max_nodes > 0:
        capacity = search_cfg.max_nodes
    elif not tree_reuse:
        capacity = num_sims + 1
    elif search_cfg.reuse_budget:
        capacity = num_sims + 8
    else:
        capacity = 2 * num_sims + 8

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

    return first_move_fn, (reuse_move_fn if tree_reuse else None)


def _budgets(cfg: SelfPlayConfig, winrate, to_move) -> np.ndarray:
    """Per-game rollout budgets from the players' winrate averages
    (`self_play.rs:218-241`; column 0 = black, 1 = white)."""
    if not cfg.winrate_rollouts:
        return np.full(len(to_move), cfg.num_rollout, np.int32)
    w = winrate[np.arange(len(to_move)), np.maximum(to_move, 1) - 1]
    m = np.maximum(4.0 * w * (1.0 - w), 0.1)
    return (m * cfg.num_rollout).astype(np.int32)


def _update_winrate(cfg: SelfPlayConfig, winrate, to_move, active, value):
    """The moving average of each player's search values, in place."""
    if cfg.winrate_rollouts:
        rows = np.arange(len(to_move))
        col = np.maximum(to_move, 1) - 1
        upd = winrate[rows, col] - cfg.winrate_momentum * (
            winrate[rows, col] - value)
        winrate[rows, col] = np.where(active, upd, winrate[rows, col])


def _game_lines(records, games, komis, territory) -> list[str]:
    """SGF lines of ``games`` from time-major move records, each game up
    to its first inactive record."""
    out = []
    for g in games:
        sgf_moves = []
        for active, move, value, to_move, targets, budget in records:
            if not active[g]:
                break
            sgf_moves.append(Played(
                to_move=int(to_move[g]), point=int(move[g]),
                value=float(value[g]), num_rollout=int(budget[g]),
                softmax=targets[g]).to_sgf())
        out.append(game_result_sgf(
            "".join(sgf_moves), komi=float(komis[g]),
            territory=territory[g]))
    return out


def _initial_states(cfg: SelfPlayConfig, batch: int, seed: int, dev):
    komi0 = random_komi(batch, seed) if cfg.random_komi \
        else np.full(batch, cfg.komi, np.float32)
    states = engine.new_states(batch, komi=cfg.komi,
                               history_len=cfg.history_len, device=dev)
    return states.replace(komi=torch.as_tensor(komi0, device=dev))


def _gather(lines: list[str], mesh) -> list[str]:
    from ..parallel import distributed as D

    return lines if mesh is None else D.all_gather_lines(lines)


def search_self_play(predictor, cfg: SelfPlayConfig,
                     search_cfg: SearchConfig | None = None, seed: int = 0,
                     sym_average: bool = False, tree_reuse: bool = True,
                     device="cuda", mesh=None) -> list[str]:
    """Play ``cfg.num_games`` MCTS games in one lockstep batch until the
    last one ends (or ``max_moves``); returns their SGF lines.  With
    ``sym_average`` every evaluation averages the eight symmetries.  With
    ``mesh`` this rank plays its ``local_game_slice`` of the games with
    its rows of the whole batch's draws, and every rank returns all the
    lines in global game order."""
    search_cfg = search_cfg or SearchConfig()
    if sym_average:
        predictor = symmetrize(predictor)
    dev = torch.device(device)
    start, count, gen = batch_rows(cfg.num_games, seed, dev, mesh)
    states = _initial_states(cfg, cfg.num_games, seed, dev).index(
        slice(start, start + count))
    first_fn, reuse_fn = _build_search_move_fn(
        predictor, search_cfg, cfg.num_rollout, cfg.temperature_moves,
        tree_reuse=tree_reuse)
    winrate = np.full((count, 2), 0.5, np.float32)
    records = []
    trees, prev_move = None, None
    no_fresh = torch.zeros(count, dtype=torch.bool, device=dev)
    for _ in range(cfg.max_moves):
        active = ~states.done.cpu().numpy()
        to_move = states.to_move.cpu().numpy()
        budget = _budgets(cfg, winrate, to_move)
        dbudget = torch.as_tensor(budget, device=dev)
        if trees is None or reuse_fn is None:
            states, trees, move, value, targets = first_fn(
                states, gen, dbudget)
        else:
            states, trees, move, value, targets = reuse_fn(
                states, trees, prev_move, gen, dbudget, no_fresh)
        prev_move = move
        value = value.cpu().numpy()
        _update_winrate(cfg, winrate, to_move, active, value)
        records.append((active, move.cpu().numpy(), value, to_move,
                        targets.cpu().numpy().astype(np.float16), budget))
        if bool(states.done.all()):
            break
    return _gather(_game_lines(records, range(count),
                               states.komi.cpu().numpy(),
                               _final_territory(states).cpu().numpy()), mesh)


def _policy_stagger(predictor, cfg: SelfPlayConfig, search_cfg: SearchConfig,
                    states: engine.GoState, seed: int) -> engine.GoState:
    """Stagger the batch across game progress with policy-only moves: slot
    ``g`` advances ``g * max_moves // B`` moves, each drawn from the policy
    head (the ``--num-rollout 1`` move rule, `self_play.rs:370-405`), so a
    continuous-batching window starts in steady state and completions
    arrive throughout it.  Slots whose game ends during the warm-up restart
    fresh and keep advancing.  The resulting games mix a policy-played
    prefix with a searched suffix: benchmark material, not training
    data."""
    b = states.batch
    dev = states.stones.device
    player = PolicyPlayer(predictor, temperature=search_cfg.temperature,
                          cutoff_percentile=search_cfg.cutoff_percentile,
                          ladder_features=search_cfg.ladder_features,
                          feature_set=search_cfg.feature_set)
    move_fn = _build_move_fn(player)
    targets = (np.arange(b) * cfg.max_moves) // b
    dtargets = torch.as_tensor(targets, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5744)
    for i in range(int(targets.max(initial=0))):
        stepped, *_ = move_fn(states, gen)
        stepped = _reset_slots(stepped, stepped.done, stepped.komi,
                               cfg.history_len)
        states = stepped.select(i < dtargets, states)
    return states


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
                                sym_average: bool = False,
                                stats: dict | None = None,
                                device="cuda",
                                game_times: list | None = None,
                                deadline_s: float | None = None,
                                initial_states: engine.GoState | None = None,
                                mesh=None) -> list[str]:
    """Full-search self-play with continuous batching; returns the SGF
    lines of the first ``cfg.num_games`` completed games.  With ``mesh``
    this rank keeps its ``local_game_slice`` of the ``batch`` slots (and
    of ``initial_states``) live, with its rows of the whole batch's
    draws, until it has completed its share of the ``cfg.num_games``
    games; every rank returns all of them, in rank order.

    ``stats`` receives ``move_events``, one ``(monotonic_time,
    active_games, charged_sims)`` tuple per move, appended after the move's
    results reach the host; ``game_times`` one ``time.monotonic()`` per
    completed game.  ``deadline_s`` stops the loop that many seconds after
    the first move returns, with the games completed so far.
    ``initial_states`` starts from prepared boards (their batch), such as
    those of :func:`_policy_stagger`.  With ``sym_average`` every
    evaluation averages the eight symmetries.
    """
    search_cfg = search_cfg or SearchConfig()
    if sym_average:
        predictor = symmetrize(predictor)
    from ..parallel import distributed as D

    dev = torch.device(device)
    rng_np = np.random.default_rng(seed)
    if initial_states is not None:
        states = initial_states
        batch = states.batch
    else:
        states = _initial_states(cfg, batch, seed, dev)
    start, count, gen = batch_rows(batch, seed, dev, mesh)
    total, batch = batch, count
    states = states.index(slice(start, start + count))
    num_games = cfg.num_games if mesh is None \
        else D.local_game_slice(cfg.num_games)[1]
    first_fn, reuse_fn = _build_search_move_fn(
        predictor, search_cfg, cfg.num_rollout, cfg.temperature_moves)

    winrate = np.full((batch, 2), 0.5, np.float32)
    records = []                 # time-major
    rec_base = 0                 # global index of records[0]
    episode_start = np.zeros(batch, np.int64)
    fresh_mask = np.zeros(batch, bool)
    games: list[str] = []
    trees, prev_move = None, None
    move_i = 0
    max_total = cfg.max_moves * (num_games + batch)

    def flush_and_refill():
        nonlocal states, records, rec_base
        done = (states.done | (states.move_count >= cfg.max_moves)) \
            .cpu().numpy()
        if not done.any():
            return
        territory = _final_territory(states).cpu().numpy()
        komis = states.komi.cpu().numpy()
        for g in np.flatnonzero(done):
            games.extend(_game_lines(
                records[int(episode_start[g]) - rec_base:], [g], komis,
                territory))
            if game_times is not None:
                game_times.append(time.monotonic())
        refill_komi = np.where(
            done,
            random_komi(total, int(rng_np.integers(1, 2**31)))[
                start:start + batch]
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

    t_deadline = None
    while len(games) < num_games and move_i < max_total and (
            t_deadline is None or time.monotonic() < t_deadline):
        active = ~states.done.cpu().numpy()
        to_move = states.to_move.cpu().numpy()
        budget = _budgets(cfg, winrate, to_move)
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
        _update_winrate(cfg, winrate, to_move, active, value)
        records.append((active, move.cpu().numpy(), value, to_move,
                        targets.cpu().numpy().astype(np.float16), budget))
        move_i += 1
        if move_i == 1 and deadline_s is not None:
            t_deadline = time.monotonic() + deadline_s
        if move_i % refill_every == 0:
            flush_and_refill()

    return _gather(games[:num_games], mesh)
