"""The closed reinforcement-learning loop: self-play -> replay -> learner
(port of `dream_go_tpu/train/rl_loop.py`).

One in-process driver replaces the reference's file-and-shell pipeline
(`README.md:63-93`: dream_go --self-play | sgf2big | sgf2balance | shuf ->
dream_tf --start -> --dump -> next generation).  Each generation:

- actor: policy play with the learner's current weights, then ex-it
  (``ex_it``), or full-search self-play (``use_search``);
- replay: a sliding window of the most recent games (sgf2recent), balanced
  between black and white wins (sgf2balance);
- learner: ``train_steps_per_generation`` train steps on an example bank
  of the balanced pool;
- ``out_dir`` gains ``gen_NNNN.sgf`` (the generation's games),
  ``ckpt_NNNN`` (the trainer's checkpoint file), ``dream_go.json`` and
  ``weights_NNNN.json`` (the weights dump).

The actor and the dumps take the learner's raw parameters and running
statistics, not the EMA that ``--dump`` writes: each generation folds a
copy of them into an inference tower (bf16 on ``cuda``).

With ``use_mesh`` every rank of the process group (`parallel/`) runs this
loop: the ranks form a ``(data, mesh_model)`` mesh, each plays its share
of the generation's games and re-searches its own games' ex-it positions,
the lines are gathered, every rank builds the same example bank from the
same seed and trains on its rows of each batch (a data-parallel learner,
the policy head split over ``model``), and rank 0 writes the files while
the others wait.  Only rank 0 logs.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import sys
import time

import torch

from ..config import ModelConfig, SearchConfig, SelfPlayConfig, TrainConfig
from ..mcts.predictor import net_predictor
from ..models import params as MP
from ..models import tower as T
from .pipeline import ExampleSource
from .train_loop import Trainer

_RESULT = re.compile(r"RE\[([BW])\+")


def balance_games(lines: list[str]) -> list[str]:
    """Equal black and white wins, alternating (sgf2balance); the lines
    unchanged when either colour has none, so the pool is never empty."""
    black = [l for l in lines if (m := _RESULT.search(l)) and m.group(1) == "B"]
    white = [l for l in lines if (m := _RESULT.search(l)) and m.group(1) == "W"]
    out = []
    for b, w in zip(black, white):
        out.append(b)
        out.append(w)
    return out or lines


@dataclasses.dataclass
class RLLoopConfig:
    generations: int = 10
    games_per_generation: int = 128
    train_steps_per_generation: int = 256
    positions_per_game: int = 8         # examples per replayed game
    ex_it_batch: int = 256              # positions per ex-it search chunk
    bank_games: int = 1024              # games per example bank (0: fresh
    #                                     games every batch)
    replay_window_games: int = 4096
    balance: bool = True
    use_search: bool = False            # False: policy play (+ ex-it)
    ex_it: bool = True
    out_dir: str | None = None
    seed: int = 0
    use_mesh: bool = False              # actor and learner over every rank
    mesh_model: int = 1                 # ranks the policy head splits over
    resume: bool = False                # continue from out_dir's last
    #                                     ckpt_NNNN, the replay refilled
    #                                     from its gen_NNNN.sgf
    warm_restart: bool = False          # on resume, restart the plateau
    #                                     schedule at warm_start_lr
    #                                     (reference --warm-start,
    #                                     __main__.py:36-39)


def serving_tower(trainer: Trainer, device) -> T.Tower:
    """An inference tower folded from a copy of the learner's current
    parameters and running statistics (not the EMA), in the compute dtype
    on ``cuda`` and float32 elsewhere; it shares no storage with the
    learner."""
    device = torch.device(device)
    cfg = trainer.model_cfg
    sd = MP.fold_train(cfg, trainer.state_dict())
    return T.from_state_dict(cfg, sd, device,
                             None if device.type == "cuda" else "float32")


def raw_weights_json(trainer: Trainer) -> str:
    """The weights JSON of the learner's raw parameters (not the EMA)."""
    cfg = trainer.model_cfg
    return MP.dump_json(cfg, *MP.to_train_tree(cfg, trainer.state_dict()))


def run_rl_loop(model_cfg: ModelConfig, train_cfg: TrainConfig,
                selfplay_cfg: SelfPlayConfig, search_cfg: SearchConfig,
                loop_cfg: RLLoopConfig, log_fn=None,
                device="cuda") -> Trainer:
    """The product RL loop on ``device``; returns the trainer.  With
    ``use_mesh`` it joins the process group first (a world of one outside
    torchrun) and runs on this rank's device."""
    from ..parallel import distributed as D

    log = log_fn or (lambda msg: print(msg, file=sys.stderr, flush=True))
    mesh = None
    if loop_cfg.use_mesh:
        from ..parallel import mesh as M

        device = D.initialize(device)
        if not D.is_writer():
            log = lambda msg: None  # noqa: E731
        mesh = M.make_mesh(model=loop_cfg.mesh_model)
        log(f"mesh: {mesh.shape}")
    device = torch.device(device)
    start_gen = 0
    trainer = None
    if loop_cfg.resume and loop_cfg.out_dir:
        ckpts = sorted(
            int(m.group(1)) for name in os.listdir(loop_cfg.out_dir)
            if (m := re.fullmatch(r"ckpt_(\d+)", name))
        ) if os.path.isdir(loop_cfg.out_dir) else []
        if ckpts:
            start_gen = ckpts[-1] + 1
            trainer = Trainer.restore(
                os.path.join(loop_cfg.out_dir, f"ckpt_{ckpts[-1]:04d}"),
                train_cfg, device)
            log(f"resume: generation {start_gen} from ckpt_{ckpts[-1]:04d}")
            if loop_cfg.warm_restart:
                from .lr_schedule import LearningRateScheduler
                trainer.scheduler = LearningRateScheduler(
                    train_cfg.warm_start_lr, train_cfg.lr_decay)
                log(f"resume: warm restart, lr schedule reset to "
                    f"{train_cfg.warm_start_lr:.2e}")
            # the checkpoint's hyperparameters win over the flags
            # (`__main__.py:93-104`), and so does its input contract
            model_cfg = trainer.model_cfg
            lf = model_cfg.ladder_features
            if lf != selfplay_cfg.ladder_features:
                log(f"resume: checkpoint ladder-feature contract = {lf}")
                selfplay_cfg = dataclasses.replace(
                    selfplay_cfg, ladder_features=lf)
                search_cfg = dataclasses.replace(
                    search_cfg, ladder_features=lf)
    if trainer is None:
        trainer = Trainer.create(model_cfg, train_cfg, seed=loop_cfg.seed,
                                 device=device)
    if mesh is not None:
        trainer.shard_over(mesh)

    # the fused leaf kernel, EARLY-C and the exact ladder reader on cuda
    # unless the caller turned them off; the portable path on the CPU
    resolved = search_cfg.resolve_auto(device)
    if resolved != search_cfg:
        search_cfg = resolved
        log(f"search: auto stack for {device.type} "
            f"(fused={search_cfg.fused}, adaptive={search_cfg.adaptive})")
    return _run_generations(trainer, train_cfg, selfplay_cfg, search_cfg,
                            loop_cfg, log, start_gen, device, mesh)


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.monotonic()


def _run_generations(trainer: Trainer, train_cfg: TrainConfig,
                     selfplay_cfg: SelfPlayConfig, search_cfg: SearchConfig,
                     loop_cfg: RLLoopConfig, log, start_gen: int,
                     device: torch.device, mesh=None) -> Trainer:
    from ..parallel import distributed as D
    from ..selfplay.policy import PolicyPlayer, policy_self_play
    from ..selfplay.reanalyze import ex_it as run_ex_it
    from ..selfplay.search_play import search_self_play

    replay: collections.deque[str] = collections.deque(
        maxlen=loop_cfg.replay_window_games)
    if start_gen and loop_cfg.out_dir:
        # refill the sliding window from the archived generations
        for g in range(max(0, start_gen - 16), start_gen):
            path = os.path.join(loop_cfg.out_dir, f"gen_{g:04d}.sgf")
            if os.path.exists(path):
                with open(path) as fh:
                    replay.extend(l.strip() for l in fh if l.strip())

    for gen in range(start_gen, loop_cfg.generations):
        predictor = net_predictor(serving_tower(trainer, device))
        sp_cfg = dataclasses.replace(
            selfplay_cfg, num_games=loop_cfg.games_per_generation)
        seed = loop_cfg.seed + gen

        t0 = _sync(device)
        t_exit = 0.0
        if loop_cfg.use_search:
            games = search_self_play(predictor, sp_cfg, search_cfg,
                                     seed=seed, device=device, mesh=mesh)
            t_play = _sync(device) - t0
        else:
            games = policy_self_play(
                PolicyPlayer(predictor,
                             ladder_features=sp_cfg.ladder_features),
                sp_cfg, seed=seed, device=device, mesh=mesh)
            t_play = _sync(device) - t0
            if loop_cfg.ex_it:
                # each rank re-searches its own games, then all gather
                start, count = (0, len(games)) if mesh is None \
                    else D.local_game_slice(len(games))
                games = run_ex_it(games[start:start + count], predictor,
                                  search_cfg,
                                  num_sims=selfplay_cfg.num_rollout,
                                  fraction=selfplay_cfg.ex_it_fraction,
                                  seed=seed,
                                  position_batch=loop_cfg.ex_it_batch,
                                  device=device)
                if mesh is not None:
                    games = D.all_gather_lines(games)
                t_exit = _sync(device) - t0 - t_play

        replay.extend(games)
        pool = balance_games(list(replay)) if loop_cfg.balance \
            else list(replay)
        log(f"gen {gen}: {len(games)} games, replay {len(replay)}, "
            f"training pool {len(pool)} "
            f"[play {t_play:.2f}s, ex-it {t_exit:.2f}s]")

        t1 = _sync(device)
        source = ExampleSource(pool, batch_size=train_cfg.batch_size,
                               seed=seed,
                               ladder_features=sp_cfg.ladder_features,
                               positions_per_game=loop_cfg.positions_per_game,
                               bank_games=loop_cfg.bank_games, device=device)
        if loop_cfg.bank_games and loop_cfg.train_steps_per_generation:
            source.build_bank()
        t_bank = _sync(device) - t1
        metrics = trainer.fit(source, loop_cfg.train_steps_per_generation,
                              log_every=0)
        t_train = _sync(device) - t1 - t_bank
        # on a mesh every rank builds the same bank (the cost is logged)
        ranks = "" if mesh is None else f" on each of {D.world_size()} ranks"
        log(f"gen {gen}: loss {metrics.get('loss', float('nan')):.4f} "
            f"top1 {metrics.get('policy_top1', 0.0):.3f} "
            f"lr {trainer.scheduler.learning_rate:.2e} "
            f"[bank {t_bank:.2f}s{ranks}, train {t_train:.2f}s]")

        if loop_cfg.out_dir:
            # every rank gathers the split tensors, rank 0 writes
            trainer.save(os.path.join(loop_cfg.out_dir, f"ckpt_{gen:04d}"))
            blob = raw_weights_json(trainer)
            if D.is_writer():
                with open(os.path.join(loop_cfg.out_dir,
                                       f"gen_{gen:04d}.sgf"), "w") as fh:
                    fh.write("\n".join(games) + "\n")
                # the latest weights, and a copy a generation for arenas
                for name in ("dream_go.json", f"weights_{gen:04d}.json"):
                    with open(os.path.join(loop_cfg.out_dir, name),
                              "w") as fh:
                        fh.write(blob)
            D.barrier()
        if trainer.scheduler.should_stop:
            log(f"gen {gen}: learning rate floor reached, stopping")
            break

    return trainer
