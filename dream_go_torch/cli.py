"""Command-line front end of the port: GTP serving, self-play, reanalyze,
the benchmark and the trainer.

    python -m dream_go_torch.cli [--gtp] [--ponder] --num-rollout R \\
        [--weights dream_go.json] [--device cuda|cpu] [--seed S]
    python -m dream_go_torch.cli --self-play N [--continuous] [--ex-it] \\
        --num-rollout R --num-games B [--max-moves M] [--seed S] \\
        [--weights dream_go.json] [--device cuda|cpu] \\
        [--ladder-features | --no-ladder-features]
    python -m dream_go_torch.cli --policy-play N [...]
    python -m dream_go_torch.cli --reanalyze FILE... [--ex-it] [...]
    python -m dream_go_torch.cli --bench [--device cuda|cpu] [bench flags]
    python -m dream_go_torch.cli --start DATA --steps N [--checkpoint CKPT] \
        [--metrics FILE] [--ladder-features] [--batch-size B] \
        [--positions-per-game K] [--bank-games G] [--seed S]
    python -m dream_go_torch.cli --resume DATA --checkpoint CKPT --steps N
    python -m dream_go_torch.cli --verify DATA --checkpoint CKPT
    python -m dream_go_torch.cli --dump --checkpoint CKPT > dream_go.json
    python -m dream_go_torch.cli --print [TENSOR...] \
        (--weights dream_go.json | --checkpoint CKPT)
    python -m dream_go_torch.cli --start DATA --lz-weights LZ.txt[.gz] ...
    python -m dream_go_torch.cli --loop GENS [--out-dir DIR] [--ex-it] \
        [--resume-loop [--warm-restart]] [--num-games G] [--num-rollout R]
    torchrun --standalone --nproc-per-node N -m dream_go_torch.cli \
        --loop GENS --mesh [--mesh-model M] [...]
    python -m dream_go_torch.cli ... --profile DIR

With no mode flag, or with ``--gtp``, the CLI serves GTP on stdin/stdout
(`dream_go_tpu/cli.py:290-294`): every genmove searches ``--num-rollout``
simulations at B=1 with EARLY-C off, and ``--ponder`` searches on in the
background between commands.  Self-play writes one SGF line per finished
game to stdout, as `dream_go_tpu/cli.py:230-283` does: ``--continuous``
keeps a batch of ``--num-games`` live games and refills finished slots;
without it the games are played in lockstep batches of ``--num-games``,
each to its last game's end; ``--policy-play N`` (or ``--num-rollout 1``)
samples each move from the policy head without a search.  ``--ex-it``
re-searches ~5% of the positions whose recorded win rate is at most 0.8
after self-play; ``--reanalyze`` re-searches ~5% of the positions of the
games in the files (``--ex-it``: ex-it's positions instead), at
``--num-rollout`` simulations, and writes the lines back out.  ``--bench``
runs :mod:`dream_go_torch.bench`, handing it ``--device`` and every
argument this parser does not know (``--full``, ``--no-selfplay``, ...).
Without ``--weights`` the net is a seeded random tower at the
``ModelConfig`` width (128 x 9 unless ``--num-channels``/``--num-blocks``
say otherwise).  Ladder planes 30/31 follow the loaded net's input
contract (its ``ladder_features:0`` tensor; off for a random net) unless
``--ladder-features``/``--no-ladder-features`` say otherwise; on ``cuda``
they come from the exact ladder kernel, on ``cpu`` from the greedy
reader.  The fused leaf kernel and EARLY-C termination are on for ``cuda``
(``--no-fused`` and ``--no-adaptive`` turn them off).  On ``cpu`` the
tower computes in float32.

The trainer procedures are those of `dream_go_tpu/cli.py:326-420`:
``--start DATA`` trains a fresh ``--num-channels`` x ``--num-blocks`` net
(its policy bias seeded from the data's move frequencies) for ``--steps``
steps on the games of the big-SGF file DATA and saves it to
``--checkpoint``; ``--resume DATA`` continues the checkpoint on DATA;
``--verify DATA`` prints the checkpoint's mean metrics over 32 batches of
DATA as one JSON line (both read planes 30/31 as the checkpoint's net
was trained, unless ``--ladder-features``/``--no-ladder-features`` say
otherwise); ``--dump`` prints its weights JSON (BN folded, the
EMA's parameters); ``--print`` prints every tensor's mean and standard
deviation of a weights file or checkpoint, or the values of the named
tensors.  Batches of ``--batch-size`` examples come from an example bank of
``--bank-games`` replayed games, ``--positions-per-game`` positions each
(``--bank-games 0``: fresh games every batch); ``--metrics`` appends one
JSON line a step.  On ``cuda`` the tower trains in bf16 with float32
parameters, and the bank's planes come from the feature and ladder
kernels.  With ``--lz-weights`` (on ``--start``, ``--resume`` and
``--verify``) the value and policy labels come from a leela-zero teacher
over the examples' LZ history planes (`dream_go_tpu/cli.py:402-407`): each
batch replays ``--batch-size`` fresh games, one position each.

``--loop GENS`` runs the closed RL loop (`dream_go_tpu/cli.py:298-323`)
into ``--out-dir``: each generation plays ``--num-games`` policy games
with the learner's current weights (``--ex-it`` re-searches ex-it
positions at ``--num-rollout`` simulations), trains ``--steps-per-gen``
steps (256) on the balanced replay window and writes ``gen_NNNN.sgf``,
``ckpt_NNNN``, ``dream_go.json`` and ``weights_NNNN.json``;
``--resume-loop`` continues from the directory's last checkpoint, and
``--warm-restart`` then restarts the learning-rate schedule at the
warm-start rate.  ``--max-moves`` caps the loop's games too.  ``--mesh``
runs the loop on every rank of the process group
(`dream_go_torch/parallel/`), one process a rank as torchrun starts them:
the games split over the ranks, a data-parallel learner whose batch norm
and gradients reduce over the ``data`` axis, and with ``--mesh-model M``
the policy head's weight split over ``M`` ranks; rank 0 writes the files,
and each rank prints its kernel launches at the end.  Outside torchrun
``--mesh`` is a world of one (JAX's ``--mesh`` spans the local devices of
one process instead).  ``--profile DIR`` records the
whole command with ``torch.profiler`` (CPU and, where there is one, CUDA
activity) into ``DIR/trace.json``, and the program's spans and counters
(`utils/spans.py`, recorded while the profiler runs) into
``DIR/spans.json``.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .config import ModelConfig, SearchConfig, SelfPlayConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="dream_go_torch")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--self-play", type=int, metavar="N",
                      help="generate N self-play games")
    mode.add_argument("--policy-play", type=int, metavar="N",
                      help="generate N policy-only games")
    mode.add_argument("--reanalyze", nargs="+", metavar="FILE",
                      help="re-annotate the games of SGF files")
    mode.add_argument("--bench", action="store_true",
                      help="run the benchmark (dream_go_torch.bench)")
    mode.add_argument("--gtp", action="store_true",
                      help="serve GTP on stdin/stdout (the default)")
    mode.add_argument("--start", metavar="DATA",
                      help="train a fresh net on a big-SGF file")
    mode.add_argument("--resume", metavar="DATA",
                      help="continue --checkpoint on a big-SGF file")
    mode.add_argument("--verify", metavar="DATA",
                      help="mean metrics of --checkpoint on a big-SGF file")
    mode.add_argument("--dump", action="store_true",
                      help="print the weights JSON of --checkpoint")
    mode.add_argument("--loop", type=int, metavar="GENS",
                      help="run the closed RL loop for GENS generations")
    mode.add_argument("--print", dest="print_tensors", nargs="*",
                      metavar="TENSOR",
                      help="print each tensor's mean and std (no names) or "
                           "the named tensors' values of --weights or "
                           "--checkpoint")
    parser.add_argument("--checkpoint", help="trainer checkpoint file")
    parser.add_argument("--lz-weights", metavar="FILE",
                        help="leela-zero weights: distil their value and "
                             "policy (--start, --resume, --verify)")
    parser.add_argument("--out-dir", default="models/rl",
                        help="output directory of --loop")
    parser.add_argument("--resume-loop", action="store_true",
                        help="--loop: continue from the out-dir's last "
                             "checkpointed generation")
    parser.add_argument("--warm-restart", action="store_true",
                        help="--loop --resume-loop: restart the learning-"
                             "rate schedule at the warm-start rate")
    parser.add_argument("--mesh", action="store_true",
                        help="--loop: actor and learner over every rank of "
                             "the process group (torchrun)")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="--loop --mesh: ranks the policy head's weight "
                             "splits over")
    parser.add_argument("--profile", metavar="DIR",
                        help="write a torch.profiler trace of the command "
                             "to DIR/trace.json and its spans to "
                             "DIR/spans.json")
    parser.add_argument("--metrics", metavar="FILE",
                        help="append training metrics JSONL to FILE")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--steps-per-gen", type=int, default=256,
                        help="--loop: train steps a generation")
    parser.add_argument("--batch-size", type=int, default=2048)
    parser.add_argument("--positions-per-game", type=int, default=8,
                        help="training examples drawn per replayed game")
    parser.add_argument("--bank-games", type=int, default=1024,
                        help="games replayed into the example bank (0: "
                             "fresh games every batch)")
    parser.add_argument("--ponder", action="store_true",
                        help="GTP: search on in the background between "
                             "commands")
    parser.add_argument("--ex-it", action="store_true",
                        help="re-search ex-it positions after self-play; "
                             "with --reanalyze, pick ex-it positions")
    parser.add_argument("--continuous", action="store_true",
                        help="continuous batching: finished games are "
                             "replaced by fresh ones; --num-games is the "
                             "live batch width")
    parser.add_argument("--weights", help="dream_go.json weights file")
    parser.add_argument("--num-rollout", type=int, default=1600)
    parser.add_argument("--num-games", type=int, default=128)
    parser.add_argument("--num-channels", type=int, default=128)
    parser.add_argument("--num-blocks", type=int, default=9)
    parser.add_argument("--num-samples", type=int, default=8)
    parser.add_argument("--softmax-temperature", type=float, default=1.0)
    parser.add_argument("--komi", type=float, default=7.5)
    parser.add_argument("--ladder-features", action="store_true",
                        default=None, dest="ladder_features",
                        help="compute ladder planes 30/31 (unset: follow "
                             "the loaded net's input contract, the "
                             "ladder_features:0 tensor of the weights)")
    parser.add_argument("--no-ladder-features", action="store_false",
                        default=None, dest="ladder_features",
                        help="skip ladder planes even if the loaded net's "
                             "contract enables them")
    parser.add_argument("--max-moves", type=int, default=None,
                        help="cap game length (default 722)")
    parser.add_argument("--no-fused", action="store_true",
                        help="disable the fused leaf_step kernel")
    parser.add_argument("--no-adaptive", action="store_true",
                        help="disable EARLY-C chunked early termination")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    return parser


def load_predictor(args, device):
    """The net: ``--weights`` through ``load_json``, else a seeded random
    tower at the configured width.  Unless the caller chose,
    ``args.ladder_features`` takes the net's input contract."""
    from .mcts import predictor as P
    from .models import params as MP
    from .models import tower as T

    dtype = None if torch.device(device).type == "cuda" else "float32"
    if args.weights:
        with open(args.weights) as fh:
            cfg, folded = MP.load_json(fh.read())
        model = T.from_state_dict(cfg, MP.to_state_dict(cfg, folded),
                                  device, dtype)
    else:
        cfg = ModelConfig(num_channels=args.num_channels,
                          num_blocks=args.num_blocks,
                          num_samples=args.num_samples)
        model = T.init_tower(cfg, seed=0, device=device, dtype=dtype)
    if args.ladder_features is None:
        args.ladder_features = cfg.ladder_features
    return P.net_predictor(model, softmax_temp=args.softmax_temperature)


def search_config(args, device, adaptive_ok: bool = True) -> SearchConfig:
    """The search configuration of ``args`` for ``device``; GTP serving
    passes ``adaptive_ok=False`` (no EARLY-C)."""
    cfg = SearchConfig(num_rollout=args.num_rollout,
                       ladder_features=bool(args.ladder_features),
                       fused=False if args.no_fused else None,
                       adaptive=False if (args.no_adaptive or not adaptive_ok)
                       else None)
    return cfg.resolve_auto(device)


def _ex_it(args, lines, predictor, device, seed: int) -> list[str]:
    from .selfplay.reanalyze import ex_it

    return ex_it(lines, predictor, search_config(args, device),
                 num_sims=args.num_rollout, seed=seed, device=device)


def _selfplay_config(args, num_games: int) -> SelfPlayConfig:
    extra = {} if args.max_moves is None else {"max_moves": args.max_moves}
    return SelfPlayConfig(num_games=num_games, num_rollout=args.num_rollout,
                          komi=args.komi, **extra)


def self_play(args, stats: dict | None = None) -> list[str]:
    """Run ``--self-play N --continuous`` and return the SGF lines."""
    from .selfplay.search_play import search_self_play_continuous

    device = torch.device(args.device)
    predictor = load_predictor(args, device)
    lines = search_self_play_continuous(
        predictor, _selfplay_config(args, args.self_play),
        search_config(args, device), seed=args.seed,
        batch=min(args.self_play, args.num_games), stats=stats,
        device=device)
    if args.ex_it:
        lines = _ex_it(args, lines, predictor, device, args.seed)
    return lines


def batched_play(args):
    """``--self-play N`` without ``--continuous`` or ``--policy-play N``:
    lockstep batches of ``--num-games``; yields SGF lines batch by batch
    and a row of dots per batch on stderr."""
    from .selfplay.policy import PolicyPlayer, policy_self_play
    from .selfplay.search_play import search_self_play

    device = torch.device(args.device)
    predictor = load_predictor(args, device)
    total = args.self_play or args.policy_play
    policy = bool(args.policy_play) or args.num_rollout <= 1
    done = 0
    while done < total:
        n = min(args.num_games, total - done)
        cfg = _selfplay_config(args, n)
        if policy:
            games = policy_self_play(
                PolicyPlayer(predictor, ladder_features=args.ladder_features),
                cfg, seed=args.seed + done, device=device)
        else:
            games = search_self_play(
                predictor, cfg, search_config(args, device),
                seed=args.seed + done, device=device)
        if args.ex_it:
            games = _ex_it(args, games, predictor, device, args.seed + done)
        yield from games
        done += n
        print("." * n, file=sys.stderr, flush=True)


def reanalyze(args) -> list[str]:
    """``--reanalyze FILE...``: the re-annotated lines of every file."""
    from .selfplay.reanalyze import ex_it, reanalyze as run_reanalyze

    device = torch.device(args.device)
    predictor = load_predictor(args, device)
    lines = []
    for path in args.reanalyze:
        with open(path) as fh:
            lines.extend(line.strip() for line in fh if line.strip())
    fn = ex_it if args.ex_it else run_reanalyze
    return fn(lines, predictor, search_config(args, device),
              num_sims=args.num_rollout, seed=args.seed, device=device)


def serve(args) -> None:
    """GTP on stdin/stdout until ``quit``."""
    from .gtp import GtpEngine, run_server

    device = torch.device(args.device)
    predictor = load_predictor(args, device)
    run_server(GtpEngine(predictor, search_config(args, device,
                                                  adaptive_ok=False),
                         num_rollout=args.num_rollout, ponder=args.ponder,
                         seed=args.seed, device=device))


def print_tensors(args) -> str:
    """``--print``: a JSON map ``{name: {mean, std}}`` of every tensor of
    the weights (``--weights`` or the dump of ``--checkpoint``), or the
    named tensors' values, one line each (`__main__.py:246-268`)."""
    import json

    import numpy as np

    from .models import params as MP

    if args.weights:
        with open(args.weights) as fh:
            tensors = MP.decode_raw(fh.read())
    elif args.checkpoint:
        from .train.train_loop import Trainer

        tensors = MP.decode_raw(
            Trainer.restore(args.checkpoint, device=args.device).dump_json())
    else:
        raise SystemExit("--print needs --weights or --checkpoint")
    if not args.print_tensors:
        return json.dumps({name: {"mean": float(np.mean(v)),
                                  "std": float(np.std(v))}
                           for name, v in tensors.items()},
                          sort_keys=True, indent=4, separators=(",", ": "))
    return "\n".join(f"{name} {tensors[name].tolist()}"
                     for name in args.print_tensors)


def trainer_procedures(args) -> list[str]:
    """``--start``, ``--resume``, ``--verify`` and ``--dump``: the lines to
    print (the metrics or the weights JSON); progress goes to stderr."""
    import json
    import time

    from .config import TrainConfig
    from .train.pipeline import ExampleSource
    from .train.train_loop import Trainer, policy_bias_from_lines

    device = torch.device(args.device)
    tcfg = TrainConfig(batch_size=args.batch_size)
    data_path = args.start or args.resume or args.verify
    lines = None
    if data_path:
        with open(data_path) as fh:
            lines = [line.strip() for line in fh if line.strip()]
    if (args.resume or args.verify or args.dump) and args.checkpoint:
        trainer = Trainer.restore(args.checkpoint, tcfg, device)
        if args.ladder_features is None:
            args.ladder_features = trainer.model_cfg.ladder_features
    else:
        if args.ladder_features is None:
            args.ladder_features = ModelConfig.ladder_features
        mcfg = ModelConfig(num_channels=args.num_channels,
                           num_blocks=args.num_blocks,
                           num_samples=args.num_samples,
                           ladder_features=args.ladder_features)
        bias = policy_bias_from_lines(lines[:2048]) if lines else None
        trainer = Trainer.create(mcfg, tcfg, seed=args.seed,
                                 policy_bias=bias, device=device)
    if args.dump:
        return [trainer.dump_json()]

    source = ExampleSource(lines, batch_size=args.batch_size, seed=args.seed,
                           ladder_features=args.ladder_features,
                           lz_history=bool(args.lz_weights),
                           positions_per_game=args.positions_per_game,
                           bank_games=args.bank_games, device=device)
    if source.bank_games:
        t0 = time.monotonic()
        feats, _ = source.build_bank()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"example bank: {feats.shape[0]} examples of "
              f"{args.bank_games} games in {time.monotonic() - t0:.3f} s",
              file=sys.stderr, flush=True)
    if args.lz_weights:
        from .train.distill import DistillationSource

        source = DistillationSource(source, args.lz_weights)
    if args.verify:
        return [json.dumps(trainer.evaluate(source, num_batches=32))]
    trainer.fit(source, num_steps=args.steps,
                log_fn=lambda msg: print(msg, file=sys.stderr, flush=True),
                metrics_path=args.metrics)
    if args.checkpoint:
        trainer.save(args.checkpoint)
    return []


def rl_loop(args):
    """``--loop GENS``: the closed RL loop into ``--out-dir``."""
    from .config import TrainConfig
    from .train.rl_loop import RLLoopConfig, run_rl_loop

    if args.ladder_features is None:
        args.ladder_features = ModelConfig.ladder_features
    extra = {} if args.max_moves is None else {"max_moves": args.max_moves}
    run_rl_loop(
        ModelConfig(num_channels=args.num_channels,
                    num_blocks=args.num_blocks,
                    num_samples=args.num_samples,
                    ladder_features=args.ladder_features),
        TrainConfig(batch_size=args.batch_size),
        SelfPlayConfig(num_games=args.num_games,
                       num_rollout=args.num_rollout, komi=args.komi,
                       ladder_features=args.ladder_features, **extra),
        SearchConfig(num_rollout=args.num_rollout,
                     ladder_features=args.ladder_features,
                     fused=False if args.no_fused else None,
                     adaptive=False if args.no_adaptive else None),
        RLLoopConfig(generations=args.loop,
                     games_per_generation=args.num_games,
                     ex_it=args.ex_it, out_dir=args.out_dir,
                     seed=args.seed,
                     positions_per_game=args.positions_per_game,
                     bank_games=args.bank_games,
                     train_steps_per_generation=args.steps_per_gen,
                     resume=args.resume_loop,
                     warm_restart=args.warm_restart,
                     use_mesh=args.mesh, mesh_model=args.mesh_model),
        device=args.device)
    if args.mesh:
        import json

        from .ops import env_step, ladder_kernel, leaf_step, libs_after
        from .parallel import distributed as D

        launches = {"leaf_step": leaf_step.launches,
                    "ladder_planes": ladder_kernel.launches,
                    "board_features_raw": libs_after.launches,
                    "env_step": env_step.launches}
        # one write, so that the ranks' lines do not interleave
        sys.stderr.write(f"rank {D.rank()} of {D.world_size()}: kernel "
                         f"launches {json.dumps(launches)}\n")
        sys.stderr.flush()
        D.shutdown()


def main(argv=None):
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest and not args.bench:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.mesh and not args.loop:
        parser.error("--mesh runs with --loop")
    if not args.profile:
        return _run(args, rest)
    from torch.profiler import ProfilerActivity, profile

    from .utils import spans

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=activities) as prof:
        rc = _run(args, rest)
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    spans.export(os.path.join(args.profile, "spans.json"))
    return rc


def _run(args, rest) -> int:
    if args.bench:
        from . import bench

        return bench.main(["--device", args.device] + rest)
    if args.loop:
        rl_loop(args)
        return 0
    if args.print_tensors is not None:
        lines = [print_tensors(args)]
    elif args.start or args.resume or args.verify or args.dump:
        lines = trainer_procedures(args)
    elif args.reanalyze:
        lines = reanalyze(args)
    elif args.self_play and args.continuous and args.num_rollout > 1:
        lines = self_play(args)
    elif args.self_play or args.policy_play:
        lines = batched_play(args)
    else:
        serve(args)
        return 0
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
