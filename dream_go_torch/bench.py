"""Benchmark of the port: prints ONE JSON line with the headline metric.

    python -m dream_go_torch.bench [--device cuda|cpu] [--full] \\
        [--no-selfplay] [--selfplay-window S] [--selfplay-rollouts R]

Port of the JAX harness `bench.py:239-509` (the same stages, metrics and
JSON keys); also ``python -m dream_go_torch.cli --bench``.  Stages, each
timed after a warm-up call and ended by a device synchronisation:

1. env (headline, ``env_steps_per_sec_per_chip``): 4096 fresh boards
   stepped in lockstep by the env_step kernel (legality with super-ko,
   uniform random move sampling, the board update), one warm-up call, then
   5 repeats of 30 calls; the median rate.  ``vs_baseline`` is against the
   100k env-steps/s north star of `bench.py`;
2. network forward of the 128 x 9 tower at batch 1024 (stderr);
3. ``mcts_sims_per_sec``: the fused search at batch 1024 in 16-simulation
   chunks after a warm-up chunk, the median of 5;
4. ``selfplay_*``: continuous full-search self-play (1600 rollouts,
   winrate budgets, EARLY-C) of 256 boards staggered over game progress by
   policy play (`search_play._policy_stagger`), run for a 600 s window
   that starts after the first move.  Games/s comes from completion times
   after the first 4 (``selfplay_rate_mode`` "completions"), or, when the
   window saw too few, from the move rate over the mean game length of 452
   (marked "extrapolated_moves_per_s");
5. with ``--full`` (stderr): SGF parse/s, feature extraction/s at batch
   1024 through the feature kernel, and the latency of one genmove (batch
   1, 100 simulations).

Stages 3 and 4 run on ``cuda`` unless ``--no-selfplay``; on the CPU the
script skips them and runs the others at small sizes (64 boards, a
forward batch of 4).  ``--selfplay-window`` and ``--selfplay-rollouts``
cut stage 4 (defaults 600 s and 1600).  Weights are a seeded random
tower.  A stage that fails ends the script with a non-zero exit and no
JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

#: env-steps/s north star of `bench.py` (``vs_baseline``)
ENV_STEPS_BASELINE = 100_000.0
#: the reference's full-search games/s at 1600 rollouts (`README.md:61-64`)
REFERENCE_GAMES_PER_S = 0.02
#: mean production game length (`bench.py:222-226`)
MEAN_GAME_MOVES = 452.0
SAMPLE_GAMES = Path(__file__).resolve().parents[1] / "tests" / "fixtures" \
    / "sample_games.sgf"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def env_stage(dev, batch: int, calls: int, reps: int = 5) -> float:
    """Median env-steps/s of ``reps`` repeats of ``calls`` env_step calls
    on ``batch`` boards (the boards' rows stay in the kernel layout)."""
    from .go import engine
    from .ops import env_step as K
    from .ops import layout

    rows = [t.contiguous() for t in layout.pack_states(
        engine.new_states(batch, device=dev))]
    weights = torch.ones(batch, 361, device=dev)
    t0 = time.monotonic()
    rows, _ = K.env_step(*rows, weights, 1)
    int(rows[4][:, 0, 2].sum())
    log(f"env: first call {time.monotonic() - t0:.2f} s")
    rates = []
    for rep in range(reps):
        t0 = time.monotonic()
        for c in range(calls):
            rows, _ = K.env_step(*rows, weights, 100 + rep * calls + c)
        total_moves = int(rows[4][:, 0, 2].sum())
        rates.append(batch * calls / max(time.monotonic() - t0, 1e-9))
    rate = statistics.median(rates)
    log(f"env steps/s over {reps} repeats of {batch * calls}: min "
        f"{min(rates):,.0f} median {rate:,.0f} max {max(rates):,.0f} "
        f"(moves on device: {total_moves})")
    return rate


def forward_stage(model, dev, batch: int, n: int = 8) -> float:
    """Network forwards/s of ``model`` on zero planes at ``batch``."""
    x = torch.zeros(batch, model.cfg.num_features, 19, 19, device=dev)
    with torch.no_grad():
        float(model(x)[0].float().sum())
        t0 = time.monotonic()
        for _ in range(n):
            out = model(x)[0]
        float(out.float().sum())
    fps = batch * n / (time.monotonic() - t0)
    log(f"nn forward/s ({model.cfg.num_blocks}x{model.cfg.num_channels}, "
        f"batch {batch}): {fps:,.0f}")
    return fps


def mcts_stage(predictor, dev, batch: int = 1024, sims: int = 16,
               reps: int = 5) -> float:
    """Fused-search simulations/s: trees of ``batch`` fresh boards, one
    warm-up chunk of ``sims`` simulations, then the median of ``reps``."""
    from .config import SearchConfig
    from .go import engine
    from .mcts import search as S

    cfg = SearchConfig(fused=True, adaptive=False).resolve_auto(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    trees = S.init_trees(engine.new_states(batch, device=dev), predictor,
                         gen, cfg, sims * (reps + 2) + 1, None)
    trees = S.run_search(trees, predictor, cfg, sims, None)
    int(trees.node_n.sum())
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        trees = S.run_search(trees, predictor, cfg, sims, None)
        int(trees.node_n.sum())
        times.append(time.monotonic() - t0)
    rate = batch * sims / statistics.median(times)
    log(f"mcts simulations/s (fused, batch {batch}, median of {reps}x{sims} "
        f"sims): {rate:,.0f}")
    return rate


def selfplay_stage(predictor, dev, window_s: float = 600.0,
                   rollouts: int = 1600, batch: int = 256,
                   max_moves: int = 722, num_games: int = 100_000) -> dict:
    """Sustained full-search self-play from policy-staggered boards (see
    module docstring); returns the ``selfplay_*`` numbers.  The run ends
    at the end of the window or after ``num_games`` completions, whichever
    comes first."""
    from .config import SearchConfig, SelfPlayConfig
    from .go import engine
    from .selfplay.search_play import (_policy_stagger,
                                       search_self_play_continuous)

    sp = SelfPlayConfig(num_games=num_games, num_rollout=rollouts,
                        max_moves=max_moves)
    cfg = SearchConfig(num_rollout=rollouts).resolve_auto(dev)
    t0 = time.monotonic()
    states = _policy_stagger(predictor, sp, cfg,
                             engine.new_states(batch, komi=sp.komi,
                                               device=dev), seed=0)
    mc = states.move_count
    log(f"selfplay warm-up: batch {batch} staggered by policy play, "
        f"move_count {int(mc.min())}..{int(mc.max())} in "
        f"{time.monotonic() - t0:.1f} s")
    game_times, stats = [], {}
    t0 = time.monotonic()
    games = search_self_play_continuous(
        predictor, sp, cfg, seed=0, batch=batch, game_times=game_times,
        deadline_s=window_s, stats=stats, device=dev, initial_states=states)
    dt = time.monotonic() - t0
    out = {"selfplay_batch": batch}
    ev = stats.get("move_events", [])
    moves_per_s = None
    if len(ev) >= 4:
        # drop the first two moves (warm-up of the search path)
        span = max(ev[-1][0] - ev[1][0], 1e-9)
        out["selfplay_sims_per_sec"] = sum(e[2] for e in ev[2:]) / span
        moves_per_s = sum(e[1] for e in ev[2:]) / span
    ramp = 4
    if len(game_times) > ramp + 1:
        w = game_times[ramp:]
        out["selfplay_games_per_sec"] = (len(w) - 1) / max(w[-1] - w[0],
                                                           1e-9)
        out["selfplay_rate_mode"] = "completions"
    elif moves_per_s is not None:
        out["selfplay_games_per_sec"] = moves_per_s / MEAN_GAME_MOVES
        out["selfplay_rate_mode"] = "extrapolated_moves_per_s"
    else:
        raise RuntimeError(f"selfplay: {len(ev)} search moves in the "
                           f"window, too few for a rate")
    log(f"selfplay: {len(games)} completions in {dt:.0f} s (batch {batch}, "
        f"{rollouts} rollouts, {len(ev)} search moves"
        + (f", {moves_per_s:.2f} moves/s" if moves_per_s else "")
        + (f", {out['selfplay_sims_per_sec']:,.0f} charged sims/s"
           if "selfplay_sims_per_sec" in out else "")
        + f"); games/s {out['selfplay_games_per_sec']:.4f} "
        f"[{out['selfplay_rate_mode']}]")
    return out


def full_stages(predictor, dev) -> None:
    """``--full``: SGF parse/s, feature extraction/s, genmove latency."""
    from .config import SearchConfig
    from .go import engine, features
    from .mcts import search as S
    from .utils import sgf

    on_gpu = torch.device(dev).type == "cuda"
    lines = [l.strip() for l in SAMPLE_GAMES.read_text().splitlines()
             if l.strip()]
    reps = 200
    t0 = time.monotonic()
    for _ in range(reps):
        for line in lines:
            sgf.parse_line(line)
    log(f"sgf parse/s (host): "
        f"{reps * len(lines) / (time.monotonic() - t0):,.0f}")

    fb = 1024 if on_gpu else 64
    fstates = engine.new_states(fb, device=dev)
    float(features.extract_batch(fstates, use_kernel=True).sum())
    n = 8
    t0 = time.monotonic()
    for _ in range(n):
        r = features.extract_batch(fstates, use_kernel=True)
    float(r.sum())
    log(f"feature extraction/s (batch {fb}, feature kernel): "
        f"{fb * n / (time.monotonic() - t0):,.0f}")

    gcfg = SearchConfig(fused=on_gpu,
                        feature_kernel=not on_gpu).resolve_auto(dev)
    gsims = 100 if on_gpu else 8
    gstates = engine.new_states(1, device=dev)
    for seed in (0, 1):
        t0 = time.monotonic()
        trees = S.search(gstates, predictor,
                         torch.Generator(device=dev).manual_seed(seed),
                         gcfg, gsims)
        int(trees.node_n.sum())
    log(f"genmove latency ({gsims} sims, batch 1): "
        f"{1e3 * (time.monotonic() - t0):,.0f} ms")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dream_go_torch.bench")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    parser.add_argument("--full", action="store_true",
                        help="also SGF parse/s, feature extraction/s and "
                             "genmove latency")
    parser.add_argument("--no-selfplay", action="store_true",
                        help="skip the search and self-play stages")
    parser.add_argument("--selfplay-window", type=float, default=600.0,
                        metavar="S", help="self-play window in seconds")
    parser.add_argument("--selfplay-rollouts", type=int, default=1600,
                        metavar="R", help="self-play rollouts per move")
    return parser


def main(argv=None) -> int:
    from .config import ModelConfig
    from .mcts.predictor import net_predictor
    from .models import tower as T

    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    on_gpu = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_gpu else "cpu"
    log(f"device: {kind}")

    steps_per_s = env_stage(dev, 4096 if on_gpu else 64,
                            30 if on_gpu else 8)
    model = T.init_tower(ModelConfig(), seed=0, device=dev,
                         dtype=None if on_gpu else "float32")
    forward_stage(model, dev, 1024 if on_gpu else 4, 8 if on_gpu else 2)
    predictor = net_predictor(model)

    mcts_sims_per_sec, selfplay = None, {}
    if on_gpu and not args.no_selfplay:
        mcts_sims_per_sec = mcts_stage(predictor, dev)
        selfplay = selfplay_stage(predictor, dev, args.selfplay_window,
                                  args.selfplay_rollouts)
    elif not args.no_selfplay:
        log("mcts and selfplay stages skipped on the CPU")
    if args.full:
        full_stages(predictor, dev)

    line = {
        "metric": "env_steps_per_sec_per_chip",
        "value": round(steps_per_s, 1),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_s / ENV_STEPS_BASELINE, 3),
        "device": kind,
    }
    if mcts_sims_per_sec is not None:
        line["mcts_sims_per_sec"] = round(mcts_sims_per_sec, 1)
    if "selfplay_games_per_sec" in selfplay:
        line["selfplay_games_per_sec"] = round(
            selfplay["selfplay_games_per_sec"], 4)
        line["selfplay_vs_reference"] = round(
            selfplay["selfplay_games_per_sec"] / REFERENCE_GAMES_PER_S, 1)
        line["selfplay_rate_mode"] = selfplay["selfplay_rate_mode"]
        line["selfplay_batch"] = selfplay["selfplay_batch"]
    if "selfplay_sims_per_sec" in selfplay:
        line["selfplay_sims_per_sec"] = round(
            selfplay["selfplay_sims_per_sec"], 1)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
