"""Driver entry points of the port (port of `__graft_entry__.py`): the
flagship tower's forward, and a dry run of the RL loop over ``n`` ranks.

    python -c 'from dream_go_torch.entry import dryrun_multichip; \\
        dryrun_multichip(2, device="cpu")'
"""

from __future__ import annotations

import math
import sys

import torch

#: how long :func:`dryrun_multichip` waits for its ranks
DRYRUN_TIMEOUT = 120.0


def entry(device="cuda"):
    """``(fn, example_args)``: the folded 128 x 9 tower's forward at
    B = 16 with seeded random weights, in the port's layout (planes first,
    ``x[16, 32, 19, 19]``); ``fn(x)`` returns ``(policy_logits[16, 362],
    value[16], ownership[16, 361])``, and ``fn.model`` is the tower (bf16
    on ``cuda``, float32 elsewhere)."""
    from .config import ModelConfig
    from .models import tower as T

    device = torch.device(device)
    cfg = ModelConfig()  # 9 blocks x 128 channels, the reference default
    model = T.init_tower(cfg, seed=0, device=device,
                         dtype=None if device.type == "cuda" else "float32")

    @torch.no_grad()
    def forward(x):
        return model(x)

    forward.model = model
    x = torch.zeros((16, cfg.num_features, 19, 19), dtype=torch.float32,
                    device=device)
    return forward, (x,)


def _dryrun_rank(rank: int, world: int, device: str) -> None:
    """One rank of :func:`dryrun_multichip`: JAX's two tiny generations,
    policy play with ex-it, then a searched generation, on a mesh whose
    policy head splits over two ranks when ``world`` is even."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    from .config import (ModelConfig, SearchConfig, SelfPlayConfig,
                         TrainConfig)
    from .parallel import distributed as D
    from .train.rl_loop import RLLoopConfig, run_rl_loop

    model = 2 if world % 2 == 0 else 1
    cfg = ModelConfig(num_channels=16, num_blocks=2, num_samples=4)
    tcfg = TrainConfig(batch_size=2 * world)
    # >= 34 moves: the example extractor drops games shorter than 30 moves
    sp_cfg = SelfPlayConfig(num_games=2 * world, num_rollout=4,
                            max_moves=40, winrate_rollouts=False)
    common = dict(generations=1, games_per_generation=2 * world,
                  train_steps_per_generation=2, use_mesh=True,
                  mesh_model=model, positions_per_game=2,
                  bank_games=2 * world, ex_it_batch=8)
    for what, loop_cfg in (
            ("rl_loop entry point", RLLoopConfig(ex_it=True, **common)),
            ("searched generation on the mesh",
             RLLoopConfig(use_search=True, ex_it=False, **common))):
        trainer = run_rl_loop(cfg, tcfg, sp_cfg, SearchConfig(), loop_cfg,
                              device=device)
        if trainer.step != loop_cfg.train_steps_per_generation:
            raise RuntimeError(f"dryrun_multichip: step {trainer.step}")
        if not all(math.isfinite(float(p.detach().sum()))
                   for p in trainer.model.parameters()):
            raise RuntimeError("dryrun_multichip: non-finite params")
        if D.is_writer():
            print(f"dryrun_multichip: OK ({what})", file=sys.stderr,
                  flush=True)
    D.shutdown()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the product RL loop (`train/rl_loop.py::run_rl_loop`) on
    ``n_devices`` ranks, spawned here, rank ``r`` on card ``r %
    device_count`` (or the CPU): one generation of policy play, ex-it and
    a data-parallel learner whose policy head splits over ``model = 2``
    (``n_devices`` even), then one searched generation.  Raises if a rank
    fails or the ranks outlast ``DRYRUN_TIMEOUT`` seconds; every rank is
    killed then."""
    from .parallel import distributed as D

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, and no card")
    D.spawn(_dryrun_rank, n_devices, (n_devices, str(device)),
            timeout=DRYRUN_TIMEOUT)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
