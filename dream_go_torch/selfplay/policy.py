"""Policy-only self-play: the reference's ``--num-rollout 1`` path.

Port of `dream_go_tpu/selfplay/policy.py` (``PolicyPlayer``,
``_build_move_fn``, ``policy_self_play``, ``random_komi``,
``_final_territory``).  All games advance in lockstep, one network
evaluation per move for the whole batch.  Reference semantics kept:

- passing is forbidden until the board is scorable: before that the
  ScoringSearch candidate mask applies (`self_play.rs:434-436`);
- the move is drawn with percentile-cutoff temperature sampling over the
  masked policy (`self_play.rs:381-386`); if nothing survives, pass;
- games end on two consecutive passes or after ``max_moves`` moves;
- per-move records carry the masked policy (``P[...]``) and the value.

The JAX package runs chunks of moves as one ``lax.scan`` program so that
a remote device is fetched once per chunk; here a host loop plays the
moves and fetches each chunk's records once.  Random draws come from one
``torch.Generator`` on the device, seeded by ``seed``.  On a mesh each
rank plays its share of the games with its rows of the whole batch's
draws (:mod:`..utils.draws`), and the lines are gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SelfPlayConfig
from ..go import benson as bn
from ..go import engine, features
from ..go.engine import GoState
from ..go.options import scoring_mask
from ..mcts.choose import choose
from ..mcts.predictor import symmetrize
from ..utils.draws import batch_rows
from .records import Played, game_result_sgf


def random_komi(n: int, seed: int = 0) -> np.ndarray:
    """Weighted random komi (`lib.rs:202-224`): 40% 7.5, 40% 6.5, 10% 0.5,
    10% uniform half-integer in [-7.5, 7.5]."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    out = np.full(n, 7.5, np.float32)
    out[u >= 0.4] = 6.5
    out[u >= 0.8] = 0.5
    rand_mask = u >= 0.9
    out[rand_mask] = rng.integers(-8, 8, rand_mask.sum()) + 0.5
    return out


def _final_territory(states: GoState) -> torch.Tensor:
    """int8[B, 361] EMPTY/BLACK/WHITE ownership of the finished boards."""
    return bn.stone_status(states.stones, states.chain_id, states.stones,
                           states.chain_id)[1]


class PolicyPlayer:
    """A predictor with its sampling settings; with ``sym_average`` each
    evaluation averages the eight symmetries."""

    def __init__(self, predictor, *, temperature: float = 0.7,
                 cutoff_percentile: float = 0.5, sym_average: bool = False,
                 ladder_features: bool = False, feature_set: str = "v1"):
        self.predict = symmetrize(predictor) if sym_average else predictor
        self.temperature = temperature
        self.cutoff_percentile = cutoff_percentile
        self.ladder_features = ladder_features
        self.feature_set = feature_set


def _build_move_fn(player: PolicyPlayer):
    """One lockstep move for the whole batch: ``move_fn(states, gen) ->
    (new_states, move, value, masked policy normalised)``.  Planes 30/31,
    when on, come from the exact reader on cuda and the greedy one on the
    CPU (the auto choice of ``SearchConfig.resolve_auto``)."""

    def move_fn(states: GoState, gen: torch.Generator):
        exact = states.stones.device.type == "cuda"
        feats = features.extract_batch(states, player.ladder_features,
                                       False, exact,
                                       feature_set=player.feature_set)
        value, policy = player.predict(feats)
        mask = torch.where(bn.is_scorable(states)[:, None],
                           engine.legal_mask(states), scoring_mask(states))
        masked = torch.where(mask, policy, 0.0)
        move = choose(gen, masked, player.cutoff_percentile,
                      player.temperature)
        move = torch.where(states.done, engine.PASS, move).to(torch.int32)
        new_states = engine.step(states, move)
        total = torch.clamp(masked.sum(-1, keepdim=True), min=1e-9)
        return new_states, move, value, masked / total

    return move_fn


def policy_self_play(player: PolicyPlayer, cfg: SelfPlayConfig,
                     seed: int = 0, device="cuda", mesh=None) -> list[str]:
    """Play ``cfg.num_games`` games to completion; returns SGF lines.

    With ``mesh`` (:mod:`..parallel.mesh`; JAX's ``sharding``) this rank
    plays its ``local_game_slice`` of the games: their initial states and
    komi, and its rows of the whole batch's random draws, so that each
    game is the one-process run's; the lines of every rank are gathered in
    global game order and returned on every rank."""
    from ..parallel import distributed as D

    dev = torch.device(device)
    total = cfg.num_games
    start, count, gen = batch_rows(total, seed, dev, mesh)
    states = engine.new_states(count, komi=cfg.komi,
                               history_len=cfg.history_len, device=dev)
    if cfg.random_komi:
        states = states.replace(komi=torch.as_tensor(
            random_komi(total, seed)[start:start + count], device=dev))
    move_fn = _build_move_fn(player)
    chunk = min(32, cfg.max_moves)

    records = []  # (active[B], move[B], value[B], to_move[B], policy f16)
    done_moves = 0
    while done_moves < cfg.max_moves:
        step = min(chunk, cfg.max_moves - done_moves)
        recs = []
        for _ in range(step):
            active, to_move = ~states.done, states.to_move
            states, move, value, policy = move_fn(states, gen)
            recs.append((active, move, value, to_move,
                         policy.to(torch.float16)))
        cols = [torch.stack(c).cpu().numpy() for c in zip(*recs)]
        records.extend(zip(*cols))
        done_moves += step
        if bool(states.done.all()):
            break

    territory = _final_territory(states).cpu().numpy()
    komis = states.komi.cpu().numpy()
    games = []
    for g in range(count):
        sgf_moves = []
        for active, move, value, to_move, policy in records:
            if not active[g]:
                break
            sgf_moves.append(Played(
                to_move=int(to_move[g]), point=int(move[g]),
                value=float(value[g]), num_rollout=1,
                softmax=policy[g]).to_sgf())
        games.append(game_result_sgf(
            "".join(sgf_moves), komi=float(komis[g]),
            territory=territory[g]))
    return games if mesh is None else D.all_gather_lines(games)
