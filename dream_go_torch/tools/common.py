"""What several tools share: the net they search with, and random
boards to measure on."""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..go import engine
from ..mcts import predictor as P
from ..models import params as MP
from ..models import tower as T


def load_net(weights: str | None, channels: int, blocks: int, device,
             seed: int = 0):
    """``(predictor, model config)``: the weights file through
    ``load_json``, or a seeded random tower of ``channels`` x ``blocks``;
    in the config's bf16 on the card and float32 on the CPU."""
    dtype = None if device.type == "cuda" else "float32"
    if weights:
        with open(weights) as fh:
            cfg, folded = MP.load_json(fh.read())
        model = T.from_state_dict(cfg, MP.to_state_dict(cfg, folded),
                                  device, dtype)
    else:
        cfg = ModelConfig(num_channels=channels, num_blocks=blocks)
        model = T.init_tower(cfg, seed=seed, device=device, dtype=dtype)
    return P.net_predictor(model), cfg


def add_ladder_flags(ap) -> None:
    """``--ladder-features`` / ``--no-ladder-features`` (unset: follow the
    net's contract, off for a random net)."""
    ap.add_argument("--ladder-features", action="store_true", default=None,
                    dest="ladder_features",
                    help="compute planes 30/31 (unset: follow the weights)")
    ap.add_argument("--no-ladder-features", action="store_false",
                    default=None, dest="ladder_features")


def opening(batch: int, moves: int, gen, device) -> engine.GoState:
    """``moves`` uniformly random legal moves on ``batch`` fresh boards."""
    states = engine.new_states(batch, device=device)
    for _ in range(moves):
        mask = engine.legal_mask(states).float()
        mv = torch.multinomial(mask, 1, generator=gen)[:, 0]
        states = engine.step(states, mv.to(torch.int32))
    return states


def random_playout(states: engine.GoState, steps: int,
                   gen: torch.Generator) -> engine.GoState:
    """Advance every board ``steps`` uniformly random legal moves (a pass
    only where no point is legal)."""
    for _ in range(steps):
        mask = engine.legal_mask(states)[:, :361]
        g = -torch.log(-torch.log(torch.rand(
            mask.shape, generator=gen, device=mask.device).clamp(
                min=1e-20)))
        mv = torch.argmax(torch.where(mask, g, float("-inf")), 1)
        mv = torch.where(mask.any(1), mv, engine.PASS)
        states = engine.step(states, mv.to(torch.int32))
    return states
