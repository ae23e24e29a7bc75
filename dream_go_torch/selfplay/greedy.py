"""Greedy scorer: roll positions out to a scorable state by policy argmax
(port of `dream_go_tpu/selfplay/greedy.py`).

Replaces `src/libdg_mcts/greedy_score.rs:33-70`: every board plays its
highest-probability ScoringSearch candidate (no pass, no eye fill) until it
is Benson-scorable or has no candidate, at most 722 moves; GTP
``final_score`` and ``final_status_list`` read the result.  The JAX
``lax.while_loop`` is a host loop over the batch, with one check of
``done.all()`` a step; a finished board passes, as in JAX.
"""

from __future__ import annotations

import torch

from ..go import benson as bn
from ..go import engine, features
from ..go.engine import GoState
from ..go.options import scoring_mask


def greedy_rollout(states: GoState, predictor, max_moves: int = 722,
                   ladder_features: bool = False,
                   ladders_exact: bool | None = None) -> GoState:
    """Batched greedy play until every board is scorable (or the cap).

    ``ladder_features`` must follow the predictor's input contract, and
    ``ladders_exact`` must be the value the search's root eval resolved
    (None: exact on ``cuda``, greedy on the CPU, as
    ``SearchConfig.resolve_auto``), so planes 30/31 keep one semantics.
    """
    if ladders_exact is None:
        ladders_exact = states.stones.device.type == "cuda"
    life = bn.life(states)          # serves the mask and the scorable test
    done = bn.is_scorable(states, life)
    for _ in range(max_moves):
        if bool(done.all()):
            break
        feats = features.extract_batch(states, ladder_features,
                                       ladders_exact=bool(ladders_exact))
        _, policy = predictor(feats)
        mask = scoring_mask(states, life)
        masked = torch.where(mask, policy.float(), float("-inf"))
        has_move = mask.any(1)
        moves = torch.where(has_move, torch.argmax(masked, 1), engine.PASS)
        moves = torch.where(done, engine.PASS, moves).to(torch.int32)
        states = engine.step(states, moves)
        life = bn.life(states)
        done = done | bn.is_scorable(states, life) | ~has_move
    return states


def greedy_score(states: GoState, predictor, ladder_features: bool = False,
                 ladders_exact: bool | None = None) -> torch.Tensor:
    """f32[B]: black minus white minus komi after greedy completion and
    Benson clearing (`get_guess_score`)."""
    finished = greedy_rollout(states, predictor,
                              ladder_features=ladder_features,
                              ladders_exact=ladders_exact)
    return bn.guess_score(finished.stones, finished.chain_id, states.komi)
