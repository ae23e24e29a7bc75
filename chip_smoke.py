"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each printed with its seconds:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   matmul and cuDNN;
2. build: every CUDA kernel of the port, one nvcc per source, and the
   leaf-step, ladder, feature and env-step kernels' bounds-checked builds
   (``-DDG_CHECK``),
   all started together; each build's ptxas report (registers, shared
   memory, spills), the checked one beside the release one;
3. parity: each kernel against its plain PyTorch version on the card, bit
   for bit.  Boards come from the port's engine (random legal play stopped
   between 0 and 250 moves, passes, finished games, a super-ko in the
   ring); the leaf-step kernel also steps the scripted boards that reach
   its counting paths (three chains merged, two captured at once, set
   unions, a ko found in a wrapped ring, a chain captured through two of
   its stones by the move and by a super-ko candidate), then its
   bounds-checked build
   on the B=1024 boards, which must not trap; the ladder kernel also
   reads the sanity-test ladder positions, the 48-capture and 12-escape
   swarms, the 31-rung staircase and a broken one, two boards on which a
   chase captures a third chain mid-ladder, and the staircase again with
   its rung budget and branch stack cut below what the chase needs (both
   must lose the capture); then its bounds-checked build on the same
   B=1024 boards and cut bounds, which must not trap; the feature kernel,
   all five rows at every point, at B = 1, 7, 256 and 1024, then the
   scripted boards that reach its counting paths (``boards.FEATURE_CASES``
   and their colour swaps: a capture through two stones, one own chain
   through two sides, two and three own chains, an own chain and a
   capture, a stone captured with its chain, a single stone, edges and
   corners, a chain over every word, ~280 chains) alone and ahead of the
   curated and random boards, then its bounds-checked build on the B=1024
   random boards and on those, which must not trap; the env-step kernel
   at B = 1, 7, 256, 1024 and 4096 with given random words, its
   Philox words, one-hot weights (a pass slot and a super-ko point among
   them, which pass) and zero weights (all pass), then 200 chained steps
   at B=256 from fresh boards, then the scripted boards that reach its
   paths (``boards.ENV_CASES``: a capture through two neighbours, suicide,
   own chains of one and two liberties, a merge of three, super-kos in a
   wrapped ring and through a two-sided capture, a ring entry that only
   the exact compare clears, a finished board, a pass slot), alone and
   ahead of the B=4096 boards, then its bounds-checked build on both,
   which must not trap;
4. reference: small self-play runs on the card (kernels) and on the CPU
   (plain versions) with a deterministic predictor give the same games:
   planes off, planes on (fused), planes on with the feature kernel
   (unfused), unfused leaves stepped by the env-step kernel, and the V2
   plane set (unfused, the predictor on 18 planes), 8 moves each (V2 6);
   then one deep search, 50 rollouts from 8 boards, whose trees on the card and
   on the CPU are equal in every field.  The CPU sides of this phase and
   of the serve phase run in two spawned processes of their own while
   the card runs;
5. self-play, each path with the kernels' launch counts set to 0 just
   before it and read just after, at the full 128 x 9 width with seeded
   random weights:
   - ``python -m dream_go_torch.cli --self-play 256 --continuous
     --num-rollout 32 --num-games 256 --max-moves 8`` (planes off),
   - the same with ``--max-moves 8 --ladder-features`` (the main path of
     this slice: leaf_step and the ladder kernel),
   - the unfused product path, ``SearchConfig(fused=False,
     feature_kernel=True, ladder_features=True)``, 64 games x 16 rollouts
     x 8 moves (the feature kernel and the ladder kernel);
   - the step-kernel search, ``SearchConfig(fused=False,
     step_kernel=True)``, 64 games x 16 rollouts x 8 moves (the env-step
     kernel, and not the leaf-step kernel);
   - GTP serving and reanalyze (the serve phase): the deterministic
     predictor's answers to `gtp_script` (genmoves, reg_genmove, a
     cleanup genmove, undo, showboard, loadsgf of a sample game cut at
     move 380, final_score, final_status_list) and its reanalyze and
     ex-it lines of the three sample games, 16 rollouts, equal on the
     card and on the CPU (computed meanwhile in a process of its own;
     any ``?`` answer fails the run); then ``cli.main(["--gtp", ...])``
     at 128 x 9 on swapped stdin/stdout: five 100-rollout genmoves, the
     same position again with one genmove at ``DEEP_ROLLOUTS`` = 200
     rollouts (cut from the CLI's default 1600) and final_score (K1 once
     per simulation), three genmoves and
     final_score with ``--weights tests/fixtures/sanity_net.json`` (K2),
     and ``--ponder`` (a move, 2 s, a genmove that continues the
     pondered tree); then ``--reanalyze`` of one self-play game of
     the rl20 run at 100 rollouts (every line parses, every patched
     move carries ``TV[100]`` and a 362-entry policy); genmove latency,
     final_score seconds, take()'s wait and positions/s are logged;
   - the trainer (the train phase) through ``cli.main`` at the CLI's
     defaults (128 x 9, B = 2048, banks of 1024 games x 8 positions):
     ``--start models/rl20/gen_0000.sgf --steps 20 --ladder-features``
     (the bank's planes from the feature and ladder kernels, its host
     side from the native loader), ``--resume`` on ``gen_0001.sgf`` for 5
     steps, ``--verify`` on ``gen_0047.sgf``, ``--dump``, then two
     16-rollout genmoves served from the dumped weights (the leaf and
     ladder kernels); every loss finite, one metrics line a step; the
     bank's seconds, the median ms of a step and examples/s logged; then
     one float32 train step at 128 x 9, B = 64, on the card against the
     CPU's (losses, gradients, running statistics, parameters after Adam,
     each within its stated limit);
   - the closed RL loop (the loop phase) through ``cli.main`` at the
     CLI's width and batch (128 x 9, B = 2048, ``--steps-per-gen 64``
     train steps a generation): ``--loop 2 --ex-it --ladder-features``
     with 32 policy games of 60 moves a generation, ex-it at 16
     rollouts and banks of 256 games, then ``--loop 3 --resume-loop
     --warm-restart`` on the same directory: each generation's files,
     every SGF line well
     formed, the step counts, the resume and warm-restart lines, finite
     losses, the leaf-step, ladder and feature kernels launched (the
     env-step kernel not), a genmove served from ``weights_0002.json``,
     and the seconds of each generation's play, ex-it, bank and train;
   - leela-zero distillation (the distill phase): a random 192 x 15
     teacher written and parsed as an LZ text file (both timed), its
     card outputs on 8 positions within the stated limits of the CPU's,
     ``--start models/rl20/gen_0047.sgf --lz-weights`` for 3 steps at
     128 x 9, B = 2048 (finite losses, the feature kernel launched), the
     distilled labels without ownership, and the ms of a step, of a
     per-batch replay and of the teacher;
   - the mesh (the mesh phase): ``torchrun --standalone
     --nproc-per-node 2 -m dream_go_torch.cli --loop 1 --mesh --ex-it
     --ladder-features`` at the loop phase's width, batch and cuts, two
     ranks sharing the card over gloo (1024 examples a rank): the
     ``mesh:`` line, 32 well-formed games, step 64, a finite loss,
     ``weights_0000.json``, and K1, K2 and K3b launched (each rank prints
     its counts, the phase sums them); then one float32 train step at 128
     x 9, B = 64, on two ranks (data 2, then model 2 with the policy head
     split) against one rank's, within the train phase's limits, and
     where a two-rank bf16 step at B = 2048 spends its time (a step on
     one rank and on two, an all-reduce of a batch norm's statistics and
     of the gradients); ``entry()`` in bf16 within the sanity net's limits
     of the CPU's float32; ``dryrun_multichip(1)`` over NCCL (run beside
     the reference phase).  Every group of ranks joins with a timeout and
     is killed on overrun;
   - the tools (the tools phase): the arena over the loop phase's three
     planes-on generations, in policy play and in 16-rollout search play,
     cut in games and moves (K2 launched, and K1 in search play);
     ``eval_accuracy`` of ``weights_0002.json`` on the sample games; 20
     ``train_supervised`` steps at 128 x 9, batch 512, on
     ``models/rl20/gen_0047.sgf`` from banks of 64 games (K3b in each
     bank); ``sgf2score`` of eight rl20 games, card lines equal to the
     CPU's; then the other tools, each cut in depth:
     ``ladder_differential`` of 200 random positions (K2 against the
     recursive oracle at every candidate point, disagreeing on at most
     0.1%), ``fuzz2gtp`` (30 genmoves, no malformed answer),
     ``bench_selfplay`` (batch 64, 16 rollouts, planes on),
     ``profile_flat`` at B=256 (every variant), ``profile_ladder
     --skip-search`` at B=1024, ``measure_ladder_cost`` at B=256,
     ``measure_eval_dupes``, ``measure_ladder_greedy``, one round of
     ``tune`` (2 games), and ``sgf2array`` of two rl20 games, card arrays
     equal to the CPU's; each tool's launches (K1 and K2) checked;
   - the workers and the trainer over one ``--root`` (the distr phase),
     at 128 x 9 in this process: a policy-play round of 64 games cut at
     40 moves with planes 30/31 on random weights (K2), a trainer
     generation of 32 steps at B = 256 from a bank of 64 games x 8
     positions (K3b, K2) whose published weights' bf16 eval matches the
     trainer's float32 net within the sanity net's limits, a second round
     on those weights (generation 0), a trainer generation resumed from
     its ``torch.save`` checkpoint, and a search-mode round of 8 games x
     8 moves x 16 rollouts on generation 1 (K1, K2); every game well
     formed and parsed;
   - the benchmark entry, ``dream_go_torch.bench.main`` in this process
     with ``--full`` and two cuts, ``--selfplay-rollouts 64
     --selfplay-window 60``: the env stage (4096 boards, 151 env-step
     launches) and the MCTS stage (batch 1024) in full; its JSON line must
     hold every key of `bench.py:488-508` with finite values;
6. sanity net: ``tests/fixtures/sanity_net.json`` loads through the CLI's
   code, turns planes 30/31 on from its contract, and evaluates the three
   ladder positions on the card in bf16 within the stated tolerance of the
   CPU's float32 eval, with equal planes;
7. timing: each kernel at the main path's batch, as CUDA-graph replays and
   as eager calls, beside its bound and its plain version; the leaf-step
   and feature kernels also at the bench's B=1024, the env-step kernel at
   B=256 and at the bench's B=4096.

The second-to-last line is the card's name and power limit, the line
before it one JSON object with a row per kernel, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises, and the script
exits non-zero without that last line, as it does where there is no CUDA
device or no checkout of the repository around it.
"""

from __future__ import annotations

import base64
import concurrent.futures
import heapq
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: the main path's shapes (planes on), cut for the mesh and tools phases
#: from 64 rollouts to 32 and from 16 moves to 8 (its games flush every 8
#: moves, so 12 still took 16 batch moves), and the planes-off run's
GAMES, ROLLOUTS, MAX_MOVES = 256, 32, 8
OFF_MOVES = 8
#: the unfused feature-kernel path, cut in depth
UNF_GAMES, UNF_ROLLOUTS, UNF_MOVES = 64, 16, 8
PARITY_BATCHES = (1, 7, 256, 1024)
#: the select walk's trees: (boards, slots), grown WALK_SIMS simulations
#: (the benchmark's self-play cell grows 256 before its window) at the
#: main path's capacity (1600 rollouts + 8)
WALK_TREES = ((256, 32), (1024, 32), (1024, 2))
WALK_SIMS, WALK_CAPACITY = 256, 1608
#: the env-step kernel also at the bench's batch
ENV_BATCHES = PARITY_BATCHES + (4096,)
ENV_CHAIN_BATCH, ENV_CHAIN_STEPS = 256, 200
#: the step-kernel search path, cut in depth
STEP_GAMES, STEP_ROLLOUTS, STEP_MOVES = 64, 16, 8
#: the deep search of the reference phase: 100 rollouts (the production
#: budget, 1600, takes ~340 s on the card and ~310 s on the CPU, more than
#: the smoke's time allows; 400 took ~145 s on a slow host, cut to 200 to
#: make room for the loop and distill phases, then to 100 for the mesh
#: and tools phases, then to 50 for the distr phase and the other tools)
REF_BOARDS, REF_SIMS = 8, 50
#: the serve phase: genmoves at 100 rollouts, then one at
#: ``DEEP_ROLLOUTS`` (cut from the CLI's default 1600, which took 39–63
#: s, to 400 for the mesh and tools phases, then to 200), three with the
#: sanity net, seconds of pondering, self-play games reanalyzed (cut from
#: eight to two, then to one; the 100-rollout genmoves from ten to five,
#: for the distr phase and the other tools); the
#: card-against-CPU session's rollouts and the move cap of its loaded
#: game (late in sample game 3, so the greedy scorer plays ~20 moves)
SERVE_ROLLOUTS, SERVE_GENMOVES, SANITY_GENMOVES = 100, 5, 3
DEEP_ROLLOUTS = 200
PONDER_WAIT, REANALYZE_GAMES = 2.0, 1
#: the first eight games of `models/rl20/gen_0000.sgf` (generation 0 of the
#: rl20 run; the generation files themselves are not committed)
REANALYZE_FILE = "tests/fixtures/rl20_gen0000_first8.sgf"
SERVE_REF_ROLLOUTS, SERVE_REF_CAP = 16, 380
#: the processes that compute the CPU references while the card runs, and
#: the torch threads of each (two, so that the reference phase's six CPU
#: runs go two at a time)
HOST_WORKERS, HOST_THREADS = 2, 3
#: the bench phase's cuts of its self-play stage (a 20 s window held 3
#: search moves, fewer than the 4 the bench needs for a rate)
BENCH_ARGS = ["--device", "cuda", "--full", "--selfplay-rollouts", "64",
              "--selfplay-window", "60"]
#: the JSON keys of `bench.py:488-508` (the error key aside)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "mcts_sims_per_sec",
              "selfplay_games_per_sec", "selfplay_vs_reference",
              "selfplay_rate_mode", "selfplay_batch", "selfplay_sims_per_sec")
#: the train phase: three generations of the rl20 run (256 self-play games
#: each), the CLI's defaults cut in steps; the dumped weights then serve
#: genmoves
TRAIN_DATA = ("models/rl20/gen_0000.sgf", "models/rl20/gen_0001.sgf",
              "models/rl20/gen_0047.sgf")
TRAIN_DIR = "build/smoke"
TRAIN_STEPS, RESUME_STEPS = 20, 5
TRAIN_GENMOVES, TRAIN_ROLLOUTS = 2, 16
#: the loop phase: ``--loop 2``, then ``--loop 3 --resume-loop
#: --warm-restart``, at the CLI's width and batch (128 x 9, B = 2048), cut
#: in depth: games a generation, ex-it rollouts, the game length (120
#: moves, then 60 for the distr phase and the other tools), the example
#: bank, and the train steps a generation (the loop's 256, then 64 for
#: the distr phase and the other tools: the mesh loop's 256 steps on two
#: ranks sharing the card took ~100 s)
LOOP_DIR = "build/smoke_loop"
LOOP_GAMES, LOOP_ROLLOUTS, LOOP_MOVES, LOOP_BANK = 32, 16, 60, 256
LOOP_STEPS = 64
#: the mesh phase: ``--loop 1 --mesh`` on two ranks sharing the card
#: (gloo) at the loop phase's cuts, killed after ``MESH_LOOP_TIMEOUT``
#: seconds (its 256 steps took 95.7 s of the 120 s first allowed, at 374
#: ms a step); every other group of ranks is killed after
#: ``MESH_TIMEOUT``; a step's parts timed over these many steps and
#: collectives (10 and 50, halved for the distr phase and the other
#: tools)
MESH_DIR = "build/smoke_mesh"
MESH_RANKS = 2
MESH_LOOP_TIMEOUT, MESH_TIMEOUT = 240.0, 120.0
MESH_TIMED_STEPS, MESH_TIMED_REDUCES = 5, 25
#: the tools phase: arena pairs of the loop phase's three generations,
#: games a pair and moves a game, in policy play and in 16-rollout search
#: play (4 games a pair, then 2 for the distr phase and the other
#: tools); supervised training at 128 x 9 on `models/rl20/gen_0047.sgf`,
#: from banks of 64 games (its default, a fresh replay of 64 games a
#: batch, took 2.5 s a step)
ARENA_GAMES, ARENA_MOVES = 8, 20
ARENA_SEARCH_GAMES, ARENA_ROLLOUTS, ARENA_SEARCH_MOVES = 2, 16, 1
SUPERVISED_STEPS, SUPERVISED_BATCH, SUPERVISED_BANK = 20, 512, 64
#: the tools phase's other tools, cut in depth: ``ladder_differential``
#: positions; ``fuzz2gtp`` genmoves; ``bench_selfplay`` batch, rollouts,
#: games, ramp games and moves; ``profile_flat``'s batch, simulations a
#: call and calls; ``profile_ladder``'s repeats (at its B=1024);
#: ``measure_ladder_cost``'s batch, simulations and calls;
#: ``measure_eval_dupes``'s simulations; ``measure_ladder_greedy``'s
#: points; ``tune``'s games, simulations and moves
DIFF_POSITIONS, FUZZ_MOVES = 200, 30
SPB_BATCH, SPB_ROLLOUTS, SPB_GAMES, SPB_RAMP, SPB_MOVES = 64, 16, 8, 2, 8
FLAT_BATCH, FLAT_SIMS, FLAT_REPEAT = 256, 4, 3
PLADDER_REPEATS = 3
LCOST_BATCH, LCOST_SIMS, LCOST_REPS = 256, 4, 2
DUPES_SIMS, GREEDY_POINTS = 32, 2000
TUNE_GAMES, TUNE_SIMS, TUNE_MOVES = 2, 16, 16
#: the distr phase: self-play workers and the trainer over one ``--root``
#: at 128 x 9: a policy-play round of ``DISTR_GAMES`` games cut at
#: ``DISTR_MOVES`` moves (the trainer keeps games of 30 moves or more), a
#: trainer generation of ``DISTR_STEPS`` steps at B = ``DISTR_BATCH`` from
#: a bank of ``DISTR_BANK`` games x ``DISTR_POSITIONS`` positions, a second
#: policy round, a resumed trainer generation, then a search-mode round
DISTR_DIR = "build/smoke_distr"
DISTR_GAMES, DISTR_MOVES = 64, 40
DISTR_BATCH, DISTR_STEPS, DISTR_BANK, DISTR_POSITIONS = 256, 32, 64, 8
DISTR_SEARCH_GAMES, DISTR_SEARCH_MOVES, DISTR_ROLLOUTS = 8, 8, 16
#: the distill phase: a random leela-zero teacher at the width of public
#: leela-zero nets (192 filters, 15 blocks), its kernels rescaled so that
#: its outputs do not saturate; ``--start --lz-weights`` for a few steps
#: at 128 x 9, B = 2048; the card's float32 teacher (TF32 off) held
#: against the CPU's on 8 positions: max |value| and max |policy|
#: (cuDNN's and the CPU's convolutions sum in other orders over 31
#: layers)
DISTILL_DIR = "build/smoke_distill"
DISTILL_FILTERS, DISTILL_BLOCKS, DISTILL_STEPS = 192, 15, 3
TEACHER_VALUE_ATOL, TEACHER_POLICY_ATOL = 1e-3, 1e-5
#: one float32 train step, card against CPU (TF32 off), 128 x 9 at
#: B = 64: the losses, relative (float32 sums over 64 examples in other
#: orders); the gradients, relative in L2 norm over all tensors and in
#: each tensor of 128 entries or more: float32 itself is that far from
#: exact at this depth, as training-mode batch norm's backward subtracts
#: the batch's mean gradient and a relu near 0 may flip (float32 against
#: float64 on the CPU, same weights and batch: 4.6e-3 in all, at most
#: 5.8e-3 in a tensor of 128 or more, 0.12 in a scalar alpha); the
#: running statistics, relative and absolute (a running mean
#: after one step is 0.01 of a batch mean, which may lie near 0); and the
#: parameters after
#: Adam, whose first step moves a weight by ~lr * sign(g), so a gradient
#: near zero whose sign differs in its last bits moves it by up to 2 lr
#: (1% more for the decay and the max-norm rescale that follow)
STEP_REF_BATCH = 64
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL, STEP_TENSOR_RTOL, STEP_GRAD_MIN_NUMEL = 2e-2, 5e-2, 128
STEP_STATS_RTOL, STEP_STATS_ATOL = 1e-4, 1e-6
STEP_ADAM_ATOL = 2 * 3e-4 * 1.01
#: the plain ladder reader runs B=1024 in chunks of this many boards
LADDER_CHUNK = 256
TIMING_BATCH = 256
#: the leaf-step kernel also at the bench's MCTS batch, the feature kernel
#: at its ``--full`` feature batch
LEAF_BENCH_BATCH = 1024
FEATURE_BENCH_BATCH = 1024
#: the sanity-test ladder positions: fixture, moves replayed, colour to move
#: (tests/test_sanity_positions.py LADDER_CASES)
LADDER_POSITIONS = [("ladder_1", 70, 1), ("ladder_2", 18, 1),
                    ("ladder_3", 54, 2)]
#: the sanity net's bf16 eval against float32, each limit set between
#: the sound readings and those of a wrong eval (planes 30/31 zeroed).
#: Max |value|, max |policy| and the policy's KL(fp32 || bf16), sound:
#: 1.95e-3 / 7.50e-4 / 1.10e-4 (bf16 on the CPU); wrong: 5.03e-3 /
#: 3.31e-3 / 1.37e-3 (bf16 on the CPU).  The phase also evaluates the
#: wrong input on the card and fails unless the limits reject it
BF16_VALUE_ATOL = 3.5e-3
BF16_POLICY_ATOL = 1.5e-3
BF16_POLICY_KL = 4e-4
#: the ladder kernel's operations bound prices what a rung needs: two
#: stones placed, each reading and updating its four neighbours' colours
#: and chain liberty counts (4 integer operations a neighbour), and the
#: extension picked among four neighbours; and a board's candidate scan
#: at 16 operations a point (four neighbours' colour and liberties)
LADDER_OPS_PER_RUNG = 2 * 4 * 4 + 4 * 4
LADDER_OPS_PER_POINT = 16
#: csrc/ladder_planes.cu runs a board's chases on 8 warps, each taking the
#: next chase when it finishes one
LADDER_WARPS = 8
#: H100 SXM HBM rate and the non-tensor-core fp32/int32 issue rate
#: (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    """Fail the run (a check that ``python -O`` does not drop)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str, t0: float, msg: str = "") -> None:
    log(f"[{name}] {msg} ({time.monotonic() - t0:.2f} s)")


# ---------------------------------------------------------------------------
# 1. device


def device_phase():
    t0 = time.monotonic()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phase("device", t0, f"{torch.cuda.get_device_name(0)} | {smi} | "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


# ---------------------------------------------------------------------------
# 2. build


def build_phase():
    from dream_go_torch.ops import build

    t0 = time.monotonic()
    jobs = [(p.stem, False) for p in sorted(build.CSRC.glob("*.cu"))]
    jobs += [("leaf_step", True), ("ladder_planes", True),
             ("libs_after", True), ("env_step", True), ("select_walk", True)]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda job: build.build(*job), jobs))
    for name, checked in sorted(jobs):
        build.load(name, checked)
        tag = f"{name}-check" if checked else name
        for line in build.BUILD_LOGS.get(tag, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {tag}: {line.strip()}")
    phase("build", t0, ", ".join(p.name for p in paths))


# ---------------------------------------------------------------------------
# 3. kernel parity


def random_boards(n: int, dev, seed: int = 0):
    """Port-engine boards on the card: random legal play stopped at move
    counts spread over 0..250 (2% passes), every 16th board a scripted ko,
    every 16th (offset 5) board finished by two passes.  Returns
    ``(states, actions)`` with actions chosen for the kind of board."""
    from dream_go_torch.go import engine
    from dream_go_torch.go.boards import KO_ACTION, KO_MOVES

    gen = torch.Generator(device=dev).manual_seed(seed)
    states = engine.new_states(n, device=dev)
    idx = torch.arange(n, device=dev)
    target = (idx * 251) // max(n, 1)
    target = target[torch.randperm(n, generator=gen, device=dev)]
    ko = (idx % 16) == 3
    fin = (idx % 16) == 5
    target = torch.where(ko, len(KO_MOVES), target)
    for i in range(int(target.max()) + 2 if n else 0):
        legal = engine.legal_mask(states)[:, :361]
        weights = torch.where(legal.any(1, keepdim=True), legal.float(), 1.0)
        pick = torch.multinomial(weights, 1, generator=gen)[:, 0]
        coin = torch.rand(n, generator=gen, device=dev) < 0.02
        act = torch.where(coin | ~legal.any(1), 361, pick)
        if i < len(KO_MOVES):
            act = torch.where(ko, KO_MOVES[i], act)
        act = torch.where(fin & (i >= target), 361, act)
        stepped = engine.step(states, act.to(torch.int32))
        keep = (i >= target) & ~fin
        states = states.select(keep, stepped)
    legal = engine.legal_mask(states)
    pick = torch.multinomial(legal.float(), 1, generator=gen)[:, 0]
    action = torch.where(ko, KO_ACTION, pick)
    action = torch.where((idx % 16) == 9, 361, action)    # a pass
    return states, action.to(torch.int32)


def leaf_step_parity(dev, states, actions):
    """K1 against its plain version: random boards at B = 1, 7, 256 and
    1024, then the scripted boards (:func:`leaf_step_cases`)."""
    from dream_go_torch.go.boards import LEAF_CASES
    from dream_go_torch.ops import layout
    from dream_go_torch.ops import leaf_step as L

    t0 = time.monotonic()
    packed = layout.pack_states(states)
    done = int(states.done.sum())
    moves = states.move_count.float()
    log(f"  boards: {states.batch}, moves {int(moves.min())}.."
        f"{int(moves.max())}, finished {done}, passes "
        f"{int((actions == 361).sum())}")
    check(done > 0 and int((actions == 361).sum()) > 0,
          "the boards lack finished games or passes")
    worst = 0.0
    perm = torch.randperm(states.batch, generator=torch.Generator()
                          .manual_seed(2)).to(dev)
    for b in PARITY_BATCHES:
        # a random draw of boards; B=7 takes one of each kind (ko,
        # finished, pass) and four mid-game boards
        sel = perm[:b]
        if b == 7:
            plain_boards = perm[(perm % 16) > 9][:4]
            sel = torch.cat([torch.tensor([3, 5, 9], device=dev),
                             plain_boards])
        args = [t[sel].contiguous() for t in packed]
        act, komi = actions[sel].contiguous(), states.komi[sel].contiguous()
        got = L.leaf_step(*args, act, komi)
        torch.cuda.synchronize()
        worst = max(worst, leaf_compare(
            f"B={b}", got, L.leaf_step_plain(*args, act, komi)))
        if bool(((sel % 16) == 3).any()):  # a ko board: plane 29 is set
            check(float(got[1][:, 29].sum()) > 0, "no super-ko plane set")
    worst = max(worst, leaf_step_cases(dev, states, actions, perm))
    phase("parity", t0, f"leaf_step bit-exact vs plain at B="
          f"{list(PARITY_BATCHES)} on the random and the scripted boards "
          f"({', '.join(c[0] for c in LEAF_CASES)}); the -DDG_CHECK build "
          f"equal at B={max(PARITY_BATCHES)}, no trap (max abs err {worst})")
    return worst


def leaf_compare(what, got, want) -> float:
    """Raise unless leaf_step's outputs equal the plain version's; returns
    the max abs error (0)."""
    worst = 0.0
    outs = list(zip(got[0], want[0])) + [(got[1], want[1]),
                                         (got[2], want[2])]
    for g, w in outs:
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:10].tolist()
            raise RuntimeError(f"leaf_step differs ({what}): {bad}")
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    return worst


def leaf_step_cases(dev, states, actions, perm) -> float:
    """The scripted boards of ``boards.LEAF_CASES``: each alone (B=1), then
    ahead of random boards at B = 7, 256 and 1024; then the bounds-checked
    build on the B=1024 batch."""
    from dream_go_torch.go import boards
    from dream_go_torch.ops import layout
    from dream_go_torch.ops import leaf_step as L

    cases, cact = boards.leaf_cases(dev)
    worst = 0.0

    def run(fn, sub, act, what):
        args = [t.contiguous() for t in layout.pack_states(sub)]
        komi = sub.komi.contiguous()
        got = fn(*args, act, komi)
        torch.cuda.synchronize()   # a trap in the checked build raises here
        return max(worst, leaf_compare(what, got, L.leaf_step_plain(
            *args, act, komi))), got

    for i, (name, _, _) in enumerate(boards.LEAF_CASES):
        one = torch.tensor([i], device=dev)
        worst, got = run(L.leaf_step, cases.index(one), cact[one],
                         f"{name}, B=1")
        # a super-ko in the wrapped ring, or through a chain captured from
        # two sides, is found
        ko = boards.LEAF_KO.get(name)
        check(ko is None or (bool(got[1][0, 29, ko])
                             and not bool(got[2][0, ko])),
              f"the super-ko of {name!r} is not found")
    for b in PARITY_BATCHES[1:]:
        sel = perm[:b - cases.batch]
        sub = cat_states([cases, states.index(sel)])
        act = torch.cat([cact, actions[sel]])
        worst, _ = run(L.leaf_step, sub, act, f"scripted + random, B={b}")
    worst, _ = run(L.leaf_step_checked, sub, act,
                   f"the -DDG_CHECK build, B={sub.batch}")
    return worst


def cat_states(parts):
    from dream_go_torch.go import engine

    return engine.GoState(**{k: torch.cat([getattr(s, k) for s in parts])
                             for k in parts[0].fields()})


def ladder_positions(dev):
    """The sanity-test ladder positions, replayed from their SGF files
    with the port's reader and engine, the colour to move set."""
    from dream_go_torch.go import engine
    from dream_go_torch.utils import sgf

    out = []
    for name, limit, color in LADDER_POSITIONS:
        with open(f"tests/fixtures/sanity/{name}.sgf") as fh:
            game = sgf.parse_line(fh.read().replace("\n", ""))
        s = engine.new_states(1, komi=game.komi, device=dev)
        for mv in game.moves[:limit]:
            s = engine.step(s.replace(to_move=torch.tensor(
                [mv.color], dtype=torch.int8, device=dev)),
                torch.tensor([mv.point], dtype=torch.int32, device=dev))
        out.append(s.replace(to_move=torch.tensor([color], dtype=torch.int8,
                                                  device=dev)))
    return cat_states(out)


def curated_boards(dev):
    """Nine boards: the ladder stress boards (the 31-rung staircase, the
    same broken by a white stone at (17,17), the 48-capture and the
    12-escape swarms), the three sanity-test ladder positions, and the two
    boards whose chases capture mid-ladder."""
    from dream_go_torch.go import boards

    return cat_states([boards.from_stones(boards.ladder_stress(), dev),
                       ladder_positions(dev),
                       boards.from_stones(boards.ladder_capture(), dev)])


def ladder_args(states):
    from dream_go_torch.ops import layout

    rows = layout.pack_states(states)
    return rows[0], rows[1], states.to_move.to(torch.int32).contiguous()


def ladder_parity(dev, states):
    """K2 against its plain version: the curated boards first, then the
    random ones, at B = 1, 7, 256 and 1024 (the plain reader in chunks of
    LADDER_CHUNK boards), then the staircase with cut bounds; then the
    bounds-checked build on the B=1024 boards and the cut bounds."""
    from dream_go_torch.go.boards import STAIRCASE_START as STAIR
    from dream_go_torch.ops import ladder_kernel as LK

    t0 = time.monotonic()
    cur = curated_boards(dev)
    boards = cat_states([cur, states.index(
        torch.arange(max(PARITY_BATCHES) - cur.batch, device=dev))])
    st, cid, tm = ladder_args(boards)
    worst = 0
    for b in PARITY_BATCHES:
        got = LK.ladder_planes_kernel(st[:b].contiguous(),
                                      cid[:b].contiguous(), tm[:b].contiguous())
        torch.cuda.synchronize()
        want = [torch.cat(x) for x in zip(*[
            LK.ladder_planes_plain(st[i:min(i + LADDER_CHUNK, b)],
                                   cid[i:min(i + LADDER_CHUNK, b)],
                                   tm[i:min(i + LADDER_CHUNK, b)])
            for i in range(0, b, LADDER_CHUNK)])]
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:10].tolist()
                raise RuntimeError(f"ladder_planes differs at B={b}: {bad}")
            worst = max(worst, int((g.int() - w.int()).abs().max()))
        if b == 7:
            cap, esc = got
            check(bool(cap[0, STAIR]) and not bool(cap[1, STAIR]),
                  "the staircase capture is not read")
            check(int(cap[2].sum()) > 0 and int(esc[3].sum()) == 12,
                  "the swarms read wrong")
            check(int(cap[4:].sum()) > 0, "no ladder in the sanity positions")
        if b == 256:
            # the capture boards: black's chase from (3, 2) captures the
            # stone at (6, 9) and wins; the escape at (2, 3) falls to a
            # counter-ladder that captures, the unit's at (15, 3) holds
            cap, esc = got
            check(bool(cap[7, STAIR]) and bool(cap[7, 19 * 7 + 9])
                  and int(cap[8].sum()) == 0,
                  "the capture board reads wrong")
            check(esc[8].nonzero()[:, 0].tolist() == [19 * 15 + 3],
                  "the escape capture board reads wrong")
    planes = [int(x.sum()) for x in got]
    want_all = want
    # the staircase with its bounds cut: 24 or 61 rungs, or no stack, lose
    # the capture (fail-safe); 62 rungs or one stack slot keep it
    sub = [t[:7].contiguous() for t in (st, cid, tm)]
    for budget, stack_cap, hit in ((24, 8, False), (61, 8, False),
                                   (62, 8, True), (320, 0, False),
                                   (320, 1, True)):
        got = LK.ladder_planes_kernel(*sub, budget, stack_cap)
        want = LK.ladder_planes_plain(*sub, budget, stack_cap)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"ladder_planes differs at budget {budget}, stack {stack_cap}")
        check(bool(got[0][0, STAIR]) == hit,
              f"staircase at budget {budget}, stack {stack_cap}")
        got = LK.ladder_planes_checked(*sub, budget, stack_cap)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"the checked build differs at budget {budget}, "
              f"stack {stack_cap}")
    # a trap in the checked build raises at this synchronisation
    got = LK.ladder_planes_checked(st, cid, tm)
    torch.cuda.synchronize()
    check(torch.equal(got[0], want_all[0]) and torch.equal(got[1],
                                                          want_all[1]),
          f"the checked build differs at B={st.shape[0]}")
    phase("parity", t0, f"ladder_planes bit-exact vs plain at B="
          f"{list(PARITY_BATCHES)} (B=1024 plain in chunks of "
          f"{LADDER_CHUNK}), capture/escape points at B={b}: {planes}; "
          "cut budget and stack fail safe; the -DDG_CHECK build equal, no "
          f"trap (max abs err {worst})")
    return float(worst)


def libs_after_parity(dev, states):
    """K3 against its plain version, all five rows at every point: random
    boards at B = 1, 7, 256 and 1024; the scripted boards of
    ``boards.FEATURE_CASES`` (and their colour swaps) alone, then ahead of
    the curated and random boards at B = 256 and 1024; then the
    bounds-checked build on the B=1024 random boards and on the scripted
    batch."""
    from dream_go_torch.go import boards
    from dream_go_torch.ops import layout
    from dream_go_torch.ops import libs_after as LA

    t0 = time.monotonic()
    worst = 0

    def run(fn, sub, what):
        st, cid = (t.contiguous() for t in layout.pack_states(sub)[:2])
        got = fn(st, cid)
        torch.cuda.synchronize()   # a trap in the checked build raises here
        want = LA.features_raw_plain(st, cid)
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:10].tolist()
            raise RuntimeError(f"libs_after differs ({what}): {bad}")
        return max(worst, int((got - want).abs().max()))

    for b in PARITY_BATCHES:
        worst = run(LA.features_raw, states.index(
            torch.arange(b, device=dev)), f"B={b}")
    cases = boards.feature_cases(dev)
    worst = run(LA.features_raw, cases, "scripted")
    scripted = cat_states([cases, curated_boards(dev)])
    for b in PARITY_BATCHES[2:]:
        sub = cat_states([scripted, states.index(
            torch.arange(b - scripted.batch, device=dev))])
        worst = run(LA.features_raw, sub, f"scripted + random, B={b}")
    worst = run(LA.features_raw_checked, states,
                f"the -DDG_CHECK build, B={states.batch}")
    worst = run(LA.features_raw_checked, sub,
                f"the -DDG_CHECK build, scripted + random, B={sub.batch}")
    small = states.index(torch.arange(7, device=dev))
    raw = LA.board_features_raw(small)
    la = LA.liberties_after_both(small)
    check(torch.equal(la[0], raw["libs_if_black"])
          and torch.equal(la[1], raw["libs_if_white"]),
          "liberties_after_both disagrees with board_features_raw")
    phase("parity", t0, f"board_features_raw (all five rows) and "
          f"liberties_after_both bit-exact vs plain at B="
          f"{list(PARITY_BATCHES)}; the scripted boards "
          f"({', '.join(c[0] for c in boards.FEATURE_CASES)}, and swapped) "
          f"alone and ahead of B={sub.batch}; the -DDG_CHECK build equal on "
          f"both, no trap (max abs err {worst})")
    return float(worst)


def env_boards(dev):
    """4096 boards of :func:`random_boards` with every ko board's capture
    played: white's recapture at (1,1) is then a super-ko."""
    from dream_go_torch.go.boards import ko_captured

    states, _ = random_boards(max(ENV_BATCHES), dev, seed=4)
    return ko_captured(states,
                       (torch.arange(states.batch, device=dev) % 16) == 3)


def env_compare(what, got, want):
    """Raise unless the kernel's rows and moves equal the plain
    version's; returns the max abs error (0)."""
    (rows, moves), (wrows, wmoves) = got, want
    worst = 0
    for g, w in list(zip(rows, wrows)) + [(moves, wmoves)]:
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:10].tolist()
            raise RuntimeError(f"env_step differs ({what}): {bad}")
        worst = max(worst, int((g.long() - w.long()).abs().max()))
    return worst


def env_step_parity(dev, states):
    """K4 against its plain version: the four cases at every batch of
    ENV_BATCHES, then ENV_CHAIN_STEPS chained Philox steps from fresh
    boards."""
    from dream_go_torch.go import engine
    from dream_go_torch.go.boards import ENV_CASES, env_step_cases
    from dream_go_torch.ops import env_step as E
    from dream_go_torch.ops import layout

    t0 = time.monotonic()
    rows = [t.contiguous() for t in layout.pack_states(states)]
    gen = torch.Generator(device=dev).manual_seed(5)
    worst, counts = 0, {}
    for b in ENV_BATCHES:
        sub = states.index(torch.arange(b, device=dev))
        args = [t[:b].contiguous() for t in rows]
        idx = torch.arange(b, device=dev)
        cases = env_step_cases(sub, gen, ko=(idx % 16) == 3,
                               pass_slots=(idx % 16) == 9)
        for name, w, bits in cases:
            got = E.env_step(*args, w, 1234 + b, bits)
            torch.cuda.synchronize()
            want = E.env_step_plain(*args, w, 1234 + b, bits)
            worst = max(worst, env_compare(f"{name}, B={b}", got, want))
            moves = got[1]
            counts[name] = counts.get(name, 0) + int((moves < 361).sum())
            if name == "one-hot":
                # the one-hot point where it is legal, else a pass; the
                # ko boards' super-ko point is not legal
                pick = w.argmax(1)
                legal = engine.legal_mask(sub)[idx, pick] & (w.sum(1) > 0)
                ko = (idx % 16) == 3
                check(not bool(legal[ko].any()),
                      "a super-ko point is legal")
                check(torch.equal(moves, torch.where(legal, pick, 361)
                                  .to(torch.int32)),
                      f"one-hot moves wrong at B={b}")
            if name == "zero":
                check(bool((moves == 361).all()), "zero weights moved")
    chain = [t.contiguous() for t in layout.pack_states(
        engine.new_states(ENV_CHAIN_BATCH, device=dev))]
    w = torch.ones(ENV_CHAIN_BATCH, 361, device=dev)
    for step in range(ENV_CHAIN_STEPS):
        got = E.env_step(*chain, w, step)
        want = E.env_step_plain(*chain, w, step)
        worst = max(worst, env_compare(f"chained step {step}", got, want))
        chain = list(got[0])
    torch.cuda.synchronize()
    placed = chain[4][:, 0, 1]
    worst = max(worst, env_step_cases_parity(dev, states, rows, gen))
    phase("parity", t0, f"env_step bit-exact vs plain at B="
          f"{list(ENV_BATCHES)}: given bits, philox, one-hot (pass slot "
          f"and super-ko point pass), zero weights (all pass); placements "
          f"{counts}; {ENV_CHAIN_STEPS} chained steps at "
          f"B={ENV_CHAIN_BATCH} (stones placed {int(placed.min())}.."
          f"{int(placed.max())}); the scripted boards "
          f"({', '.join(c[0] for c in ENV_CASES)}) alone and ahead of "
          f"B={states.batch}; the -DDG_CHECK build equal on both, no trap "
          f"(max abs err {worst})")
    return float(worst)


def env_step_cases_parity(dev, states, rows, gen) -> int:
    """K4 on the scripted boards of ``boards.ENV_CASES`` (one-hot weights):
    each alone (B=1, Philox), then all ahead of ``states`` (uniform
    weights) with Philox and with given words; then the bounds-checked
    build on that batch, both modes."""
    from dream_go_torch.go import boards
    from dream_go_torch.ops import env_step as E
    from dream_go_torch.ops import layout

    cases, cw, cmoves = boards.env_cases(dev)
    worst = 0
    for i, (name, _, _, _) in enumerate(boards.ENV_CASES):
        one = torch.tensor([i], device=dev)
        args = [t.contiguous() for t in layout.pack_states(cases.index(one))]
        got = E.env_step(*args, cw[one], 21)
        torch.cuda.synchronize()
        worst = max(worst, env_compare(f"{name}, B=1", got, E.env_step_plain(
            *args, cw[one], 21)))
        check(int(got[1][0]) == int(cmoves[i]),
              f"{name}: moved {int(got[1][0])}, not {int(cmoves[i])}")
    crows = layout.pack_states(cases)
    args = [torch.cat([c, r[:states.batch - cases.batch]]).contiguous()
            for c, r in zip(crows, rows)]
    b = args[0].shape[0]
    w = torch.cat([cw, torch.ones(b - cases.batch, 361, device=dev)])
    bits = torch.randint(-2**31, 2**31, (b, 361), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    for fn, tag in ((E.env_step, ""), (E.env_step_checked, ", -DDG_CHECK")):
        for given in (None, bits):
            got = fn(*args, w, 22, given)
            torch.cuda.synchronize()   # a trap in the checked build raises
            mode = "philox" if given is None else "given bits"
            worst = max(worst, env_compare(
                f"scripted + random, B={b}, {mode}{tag}", got,
                E.env_step_plain(*args, w, 22, given)))
            check(torch.equal(got[1][:cases.batch], cmoves),
                  f"scripted moves {got[1][:cases.batch].tolist()}{tag}")
    return worst


def walk_trees(dev, batch: int, slots: int = 32):
    """Trees the port's search grows on the card, ``WALK_SIMS``
    simulations at the main path's capacity, for the select walk's parity
    and timing: ``(trees, cfg)`` (~10 GB at B = 1024)."""
    from dream_go_torch.mcts import walk_cases

    return walk_cases.grown_trees(dev, batch, WALK_SIMS, slots=slots,
                                  seed=batch + slots, capacity=WALK_CAPACITY)


def walk_compare(what, got, want) -> float:
    """Raise unless the select walk's six outputs equal the plain
    version's; returns the max abs error (0)."""
    names = ("node", "action", "k_exit", "path_n", "path_k", "root_a")
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            bad = (g != w).nonzero()[:10].tolist()
            raise RuntimeError(f"select_walk differs ({what}, {name}): {bad}")
    return 0.0


def select_walk_parity(dev) -> float:
    """The select walk's kernel against its plain version: trees grown by
    the port's search at B = 256 and 1024 (K = 32, and 2 at B = 1024), the
    same trees with their statistics redrawn (three roots without a
    candidate), a line past the depth bound; then the checked build on
    the B = 1024 trees."""
    from dream_go_torch.mcts import walk_cases
    from dream_go_torch.ops import select_walk as SW

    t0 = time.monotonic()
    levels = []

    def compare(what, t, cfg):
        b, c = t.node_n.shape
        args = (t, cfg.uct_exp, cfg.fpu_reduce, b, c)
        want = SW.select_walk_plain(*args)
        walk_compare(what, SW.select_walk(*args), want)
        if b == 1024:
            got = SW.select_walk_checked(*args)
            torch.cuda.synchronize()
            walk_compare(f"{what}, checked", got, want)
        lv = (want[3][:, 1:] >= 0).sum(1)
        levels.append(f"{what}: levels {float(lv.float().mean()):.2f} mean, "
                      f"{int(lv.max())} max")
        return want

    for b, slots in WALK_TREES:   # one batch of trees on the card at a time
        t, cfg = walk_trees(dev, b, slots)
        compare(f"B={b} K={slots}", t, cfg)
        compare(f"B={b} K={slots} redrawn", walk_cases.perturbed(t, b, 3), cfg)
        del t
    want = compare("line past the depth bound", *walk_cases.line_trees(dev))
    check(bool((want[2] >= 0).all()), "the line did not reach the bound")
    phase("parity", t0, "select_walk bit-exact vs plain on " + "; ".join(
        levels) + "; the -DDG_CHECK build equal at B=1024, no trap")
    return 0.0


def parity_phase(dev):
    states, actions = random_boards(max(PARITY_BATCHES), dev, seed=1)
    env_states = env_boards(dev)
    errs = {"leaf_step": leaf_step_parity(dev, states, actions),
            "ladder_planes": ladder_parity(dev, states),
            "board_features_raw": libs_after_parity(dev, states),
            "env_step": env_step_parity(dev, env_states),
            "select_walk": select_walk_parity(dev)}
    return errs, states, actions, env_states


# ---------------------------------------------------------------------------
# 4. reference: kernel path on the card == plain path on the CPU


def det_predictor():
    """A deterministic predictor whose policy and value are dyadic numbers
    (float32 sums of them are exact in any order), so the search decisions
    do not depend on where it runs; it takes V1's 32 planes or V2's 18."""
    from dream_go_torch.mcts.predictor import Predictor

    w = torch.from_numpy(
        (np.arange(19 * 19 * 32).reshape(19, 19, 32) % 7 + 1).astype(np.int32))

    def predict(feats):
        bits = (feats > 0.5).to(torch.int32)
        h = (bits * w[..., :feats.shape[-1]].to(feats.device)).sum(
            dim=(1, 2, 3))
        a = torch.arange(362, dtype=torch.int32, device=feats.device)
        k = (h[:, None] * 31 + a[None, :] * 17) % 251 + 1
        return ((h % 200) + 28).float() / 256.0, k.float() / 4096.0

    return Predictor(predict)


#: the reference phase's search configurations: a name, the search
#: knobs and the game length; the kernel each must launch on the card is
#: in `reference_phase`.  The runs are cut from 12 moves to 8 (V2, which
#: runs no kernel, to 6) to make room for the loop and distill phases;
#: shorter games cost the same, as continuous play flushes finished games
#: every 8 moves
REF_VARIANTS = [
    ("planes off, fused", dict(fused=True), 8),
    ("planes on, fused", dict(fused=True, ladder_features=True,
                              ladders_exact=True), 8),
    ("planes on, unfused, feature kernel",
     dict(fused=False, feature_kernel=True, ladder_features=True,
          ladders_exact=True), 8),
    ("unfused, step kernel", dict(fused=False, step_kernel=True), 8),
    ("V2, unfused", dict(fused=False, feature_set="v2"), 6)]


def reference_selfplay(kw, device, moves) -> list[str]:
    """4 games x 16 rollouts x ``moves`` moves of self-play with the
    deterministic predictor, no noise, EARLY-C, the search knobs ``kw``,
    on ``device``: the SGF lines with their dates stripped."""
    from dream_go_torch.config import SearchConfig, SelfPlayConfig
    from dream_go_torch.selfplay.search_play import \
        search_self_play_continuous

    cfg = SelfPlayConfig(num_games=4, num_rollout=16, max_moves=moves,
                         temperature_moves=0)
    scfg = SearchConfig(num_rollout=16, dirichlet_noise=0.0, adaptive=True,
                        **kw)
    return [re.sub(r"DT\[[^\]]*\]", "", g)
            for g in search_self_play_continuous(
                det_predictor(), cfg, scfg, seed=0, batch=4, device=device)]


def reference_phase(dev, host):
    """Card and CPU self-play, deterministic predictor, the search
    configurations of ``REF_VARIANTS``; the CPU's runs go to ``host``, a
    process of its own, while the card runs.  With planes on, the card
    reads ladders with the kernel (every candidate) and the CPU with the
    bounded exact reader (24 capture and 8 escape starts a board); from
    empty boards no position of these 8-move games comes near those
    bounds, so the two agree, and the bound tests
    (tests/test_torch_ladder.py) hold the difference."""
    from dream_go_torch.ops import env_step as E
    from dream_go_torch.ops import ladder_kernel as LK
    from dream_go_torch.ops import libs_after as LA

    t0 = time.monotonic()
    on_host = [host.submit(reference_selfplay, kw, "cpu", moves)
               for _, kw, moves in REF_VARIANTS]
    host_trees = host.submit(production_trees, "cpu")
    for (name, kw, moves), kernel, cpu in zip(REF_VARIANTS,
                                              (None, LK, LA, E, None),
                                       on_host):
        before = kernel.launches if kernel else 0
        card = reference_selfplay(kw, dev, moves)
        check(kernel is None or kernel.launches > before,
              f"the card run did not launch its kernel ({name})")
        check(len(card) == 4 and card == cpu.result(),
              f"self-play on the card differs from the CPU ({name})")
    phase("reference", t0, "4 games x 16 rollouts, card (kernels) == cpu "
          "(plain), move for move: " + "; ".join(v[0] for v in REF_VARIANTS))
    production_search(dev, host_trees)


def tree_fields(tree):
    """``(name, tensor)`` of every field of a search tree, the per-node
    board rows included."""
    import dataclasses

    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            yield f.name, v
        else:
            for k, x in v.fields().items():
                yield f"{f.name}.{k}", x


def production_trees(device):
    """The trees of one deep search, REF_SIMS rollouts
    from REF_BOARDS boards of random play (a ko, a finished game among
    them), deterministic predictor, no noise, the fused path (leaf_step on
    the card, its plain version on the CPU), on ``device``; and its
    seconds."""
    from dream_go_torch.config import SearchConfig
    from dream_go_torch.mcts import search as TS

    states, _ = random_boards(REF_BOARDS, "cpu", seed=6)
    states = states.replace(**{k: v.to(device)
                               for k, v in states.fields().items()})
    t0 = time.monotonic()
    trees = TS.search(states, det_predictor(),
                      torch.Generator(device=device),
                      SearchConfig(dirichlet_noise=0.0, fused=True), REF_SIMS)
    return trees, time.monotonic() - t0


def production_search(dev, host_trees):
    """The card's trees of :func:`production_trees` against the CPU's
    (``host_trees``, a future of the CPU's), equal in every field."""
    from dream_go_torch.ops import leaf_step as L

    t0 = time.monotonic()
    before = L.launches
    card, secs = production_trees(dev)
    check(L.launches - before >= REF_SIMS,
          "the card's search did not run leaf_step")
    host, host_secs = host_trees.result()
    for (name, a), (_, b) in zip(tree_fields(card), tree_fields(host)):
        if not torch.equal(a.cpu(), b):
            bad = (a.cpu() != b).nonzero()[:10].tolist()
            raise RuntimeError(f"the {REF_SIMS}-rollout trees differ in "
                               f"{name}: {bad}")
    sizes = host.size.tolist()
    check(max(sizes) > REF_SIMS // 2, f"tree sizes {sizes}")
    phase("reference", t0, f"{REF_SIMS} rollouts x {REF_BOARDS} boards, "
          f"trees equal in every field (card {secs:.1f} s, cpu "
          f"{host_secs:.1f} s; tree sizes {sizes})")


# ---------------------------------------------------------------------------
# 5. the main path

SGF_RE = re.compile(
    r"^\(;GM\[1\]FF\[4\]DT\[[^\]]*\]SZ\[19\]RU\[Chinese\]KM\[-?\d+\.\d\]"
    r"RE\[(?:[BW]\+\d+\.\d|0)\]"
    r"((?:;[BW]\[(?:[a-s]{2})?\]TV\[\d+\]P\[[^\]]+\]V\[-?\d\.\d{4}\])+)"
    r"(?:TB(?:\[[a-s]{2}\])+)?(?:TW(?:\[[a-s]{2}\])+)?\)$")
MOVE_RE = re.compile(r";([BW])\[([a-s]{2})?\]TV\[(\d+)\]P\[([^\]]+)\]"
                     r"V\[(-?\d\.\d{4})\]")


def check_sgf(line: str, rollouts: int = ROLLOUTS) -> int:
    """Raise unless ``line`` is a well-formed self-play record; returns its
    number of moves."""
    m = SGF_RE.match(line)
    check(m, f"malformed SGF line: {line[:200]}")
    moves = MOVE_RE.findall(m.group(1))
    for i, (color, _, tv, blob, value) in enumerate(moves):
        policy = np.frombuffer(base64.b85decode(blob), np.float16)
        check(color == "BW"[i % 2] and 1 < int(tv) <= rollouts
              and policy.shape == (362,) and np.isfinite(policy).all()
              and abs(float(policy.astype(np.float32).sum()) - 1.0) < 0.02
              and -1.0 <= float(value) <= 1.0,
              f"bad move {i} in SGF line: {line[:200]}")
    return len(moves)


def kernel_modules():
    from dream_go_torch.ops import env_step, ladder_kernel, leaf_step, \
        libs_after, select_walk

    return {"leaf_step": leaf_step, "ladder_planes": ladder_kernel,
            "board_features_raw": libs_after, "env_step": env_step,
            "select_walk": select_walk}


def counted(run):
    """``run()`` with every kernel's launch count set to 0 just before and
    read just after: ``(result, launches, seconds)``."""
    mods = kernel_modules()
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    t0 = time.monotonic()
    out = run()
    torch.cuda.synchronize()
    return out, {k: m.launches for k, m in mods.items()}, \
        time.monotonic() - t0


def drive(name, run, games, rollouts, expect):
    """Run one self-play path with the launch counts zeroed before and
    read after; ``expect`` names the kernels the path must launch."""
    stats = {}
    t0 = time.monotonic()
    lines, launches, wall = counted(lambda: run(stats))
    check(len(lines) == games, f"{name}: {len(lines)} games, not {games}")
    moves = sum(check_sgf(g, rollouts) for g in lines)
    events = stats["move_events"]
    sims = sum(e[2] for e in events)
    for k in expect:
        check(launches[k] > 0, f"{name}: the path never launched {k}")
    phase(name, t0,
          f"128x9 net, {games} games x {rollouts} rollouts, {len(events)} "
          f"batch moves, {moves} game moves, launches {launches}; games/s "
          f"{games / wall:.3f} moves/s {moves / wall:.1f} "
          f"sims/s {sims / wall:.1f}")
    return launches, len(events)


def selfplay_phase(dev):
    from dream_go_torch import cli
    from dream_go_torch.config import SearchConfig, SelfPlayConfig
    from dream_go_torch.selfplay.search_play import \
        search_self_play_continuous

    def cli_args(moves, *extra):
        args = cli.build_parser().parse_args([
            "--self-play", str(GAMES), "--continuous", "--num-rollout",
            str(ROLLOUTS), "--num-games", str(GAMES), "--max-moves",
            str(moves), "--seed", "0", *extra])
        check((args.num_channels, args.num_blocks) == (128, 9),
              "the main path runs at 128 x 9")
        return args

    off = cli_args(OFF_MOVES)
    launches_off, _ = drive(
        "selfplay (planes off)", lambda st: cli.self_play(off, stats=st),
        GAMES, ROLLOUTS, ["leaf_step", "select_walk"])
    check(launches_off["ladder_planes"] == 0, "planes off read ladders")

    on = cli_args(MAX_MOVES, "--ladder-features")
    launches_on, moves = drive(
        "selfplay A (planes on)", lambda st: cli.self_play(on, stats=st),
        GAMES, ROLLOUTS, ["leaf_step", "ladder_planes", "select_walk"])
    # one ladder launch per lockstep simulation (= leaf_step launch) and
    # one per root evaluation (= batch move)
    check(launches_on["ladder_planes"] >= launches_on["leaf_step"] + moves,
          "selfplay A: fewer ladder launches than simulations + root evals")

    unf = cli_args(UNF_MOVES, "--ladder-features", "--no-fused")
    predictor = cli.load_predictor(unf, dev)
    scfg = SearchConfig(num_rollout=UNF_ROLLOUTS, fused=False,
                        feature_kernel=True,
                        ladder_features=True).resolve_auto(dev)
    cfg = SelfPlayConfig(num_games=UNF_GAMES, num_rollout=UNF_ROLLOUTS,
                         max_moves=UNF_MOVES)
    launches_unf, _ = drive(
        "selfplay B (unfused, feature kernel)",
        lambda st: search_self_play_continuous(
            predictor, cfg, scfg, seed=0, batch=UNF_GAMES, stats=st,
            device=dev),
        UNF_GAMES, UNF_ROLLOUTS,
        ["board_features_raw", "ladder_planes", "select_walk"])
    check(launches_unf["leaf_step"] == 0, "the unfused path ran leaf_step")

    step = cli_args(STEP_MOVES, "--no-fused")
    predictor = cli.load_predictor(step, dev)
    scfg = SearchConfig(num_rollout=STEP_ROLLOUTS, fused=False,
                        step_kernel=True).resolve_auto(dev)
    cfg = SelfPlayConfig(num_games=STEP_GAMES, num_rollout=STEP_ROLLOUTS,
                         max_moves=STEP_MOVES)
    launches_step, _ = drive(
        "selfplay C (unfused, step kernel)",
        lambda st: search_self_play_continuous(
            predictor, cfg, scfg, seed=0, batch=STEP_GAMES, stats=st,
            device=dev),
        STEP_GAMES, STEP_ROLLOUTS, ["env_step", "select_walk"])
    check(launches_step["leaf_step"] == 0,
          "the step-kernel path ran leaf_step")
    # every search on the card walks its trees with the kernel, one launch
    # a simulation
    check(launches_on["select_walk"] >= launches_on["leaf_step"],
          "selfplay A: fewer select-walk launches than simulations")
    return {"leaf_step": launches_on["leaf_step"],
            "ladder_planes": launches_on["ladder_planes"],
            "board_features_raw": launches_unf["board_features_raw"],
            "select_walk": launches_on["select_walk"]}


# ---------------------------------------------------------------------------
# 5a. GTP serving, reanalyze and ex-it


def sample_lines() -> list[str]:
    """The three games of ``tests/fixtures/sample_games.sgf``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures", "sample_games.sgf")
    with open(path) as fh:
        return [line.strip() for line in fh if line.strip()]


def gtp_script(sgf_path: str, cap: int = SERVE_REF_CAP) -> list[str]:
    """The GTP session held card against CPU: genmoves of every kind,
    undo, a loaded game cut at ``cap`` moves, and its score."""
    return ["clear_board", "komi 6.5", "play b q16", "genmove w",
            "genmove b", "genmove w", "reg_genmove b",
            "kgs-genmove_cleanup b", "undo", "showboard",
            "gomill-explain_last_move", f"loadsgf {sgf_path} {cap}",
            "showboard", "final_score", "final_status_list dead", "quit"]


def gtp_answers(engine, script) -> list[str]:
    """The engine's answer to each command; a ``?`` answer fails the run
    (the engine turns every exception, a kernel fault too, into one)."""
    out = []
    for cmd in script:
        answer, _ = engine.handle(cmd)
        check(not answer.startswith("?"),
              f"GTP {cmd!r} answered {answer.strip()!r}")
        out.append(answer)
    return out


def serve_reference(device, sgf_path: str):
    """The deterministic predictor's GTP answers to :func:`gtp_script`
    (16 rollouts, no noise), and its reanalyze and ex-it lines of the
    sample games (16 rollouts, EARLY-C off), dates stripped, on
    ``device``."""
    from dream_go_torch.config import SearchConfig
    from dream_go_torch.gtp import GtpEngine
    from dream_go_torch.selfplay import reanalyze as RA

    eng = GtpEngine(det_predictor(), SearchConfig(dirichlet_noise=0.0),
                    num_rollout=SERVE_REF_ROLLOUTS, device=device)
    answers = gtp_answers(eng, gtp_script(sgf_path))
    cfg = SearchConfig(dirichlet_noise=0.0, adaptive=False)
    annotated = [[re.sub(r"DT\[[^\]]*\]", "", line)
                  for line in fn(sample_lines(), det_predictor(), cfg,
                                 num_sims=SERVE_REF_ROLLOUTS, device=device)]
                 for fn in (RA.reanalyze, RA.ex_it)]
    return answers, annotated


class ScriptedIO:
    """stdin and stdout of an in-process GTP session: yields the script's
    lines (a number in the script waits that many seconds) and keeps
    each answer with the seconds since its command was read."""

    def __init__(self, script):
        self.script = script
        self.answers = []
        self._sent = None

    def __iter__(self):
        for item in self.script:
            if isinstance(item, (int, float)):
                time.sleep(item)
                continue
            self._sent = time.monotonic()
            yield item + "\n"

    def write(self, text):
        self.answers.append((text.strip(), time.monotonic() - self._sent))

    def flush(self):
        pass


def gtp_session(argv, script):
    """``cli.main(argv)`` serving ``script`` on swapped stdin/stdout, with
    the launch counts zeroed before and read after: ``(answers,
    launches)``, each answer ``(cmd, text, seconds)``."""
    from dream_go_torch import cli

    io_ = ScriptedIO(script)

    def run():
        saved = sys.stdin, sys.stdout
        sys.stdin, sys.stdout = io_, io_
        try:
            return cli.main(argv)
        finally:
            sys.stdin, sys.stdout = saved

    rc, launches, _ = counted(run)
    check(rc == 0, f"cli.main({argv}) exited {rc}")
    cmds = [c for c in script if isinstance(c, str)]
    check(len(io_.answers) == len(cmds), f"{len(io_.answers)} answers to "
          f"{len(cmds)} commands")
    for cmd, (text, _) in zip(cmds, io_.answers):
        check(text.startswith("="), f"GTP {cmd!r} answered {text!r}")
    return [(c, t, s) for c, (t, s) in zip(cmds, io_.answers)], launches


def serve_phase(dev, host):
    """GTP serving and reanalyze on the card: the card's answers and
    annotated lines against the CPU's (computed meanwhile by ``host``, a
    process of its own), then GTP at the full 128 x 9 width (100-rollout genmoves,
    one at ``DEEP_ROLLOUTS``, final_score; the sanity net, whose
    planes 30/31 run K2; pondering) and reanalyze of real self-play games,
    each with the kernels' launch counts zeroed before and read after."""
    import contextlib
    import io
    import statistics
    import tempfile

    from dream_go_torch import cli
    from dream_go_torch.gtp.ponder import PonderService
    from dream_go_torch.utils import sgf

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        game = f"{tmp}/game.sgf"
        with open(game, "w") as fh:
            fh.write(sample_lines()[2] + "\n")
        on_host = host.submit(serve_reference, "cpu", game)

        # 1. the card's answers and lines == the CPU's
        t0 = time.monotonic()
        (answers, annotated), launches, _ = counted(
            lambda: serve_reference(dev, game))
        check(launches["leaf_step"] > 0, "GTP and reanalyze on the card "
              "never launched leaf_step")
        card_secs = time.monotonic() - t0

        # 2. GTP at full width
        t0 = time.monotonic()
        moves = [f"genmove {'bw'[i % 2]}" for i in range(SERVE_GENMOVES)]
        got, launches_a = gtp_session(
            ["--gtp", "--num-rollout", str(SERVE_ROLLOUTS), "--seed", "0"],
            ["clear_board"] + moves + ["quit"])
        played = [(cmd[-1], text[2:]) for cmd, text, _ in got
                  if cmd.startswith("genmove")]
        check(all(v != "resign" for _, v in played), f"resigned: {played}")
        lat100 = [s for cmd, _, s in got if cmd.startswith("genmove")]
        check(launches_a["leaf_step"] >= SERVE_ROLLOUTS * SERVE_GENMOVES,
              f"100-rollout genmoves: launches {launches_a}")
        got, launches_b = gtp_session(
            ["--gtp", "--num-rollout", str(DEEP_ROLLOUTS), "--seed", "0"],
            ["clear_board"] + [f"play {c} {v}" for c, v in played]
            + ["genmove b", "final_score", "quit"])
        lat_deep = got[-3][2]
        score, score_secs = got[-2][1], got[-2][2]
        check(launches_b["leaf_step"] >= DEEP_ROLLOUTS,
              f"{DEEP_ROLLOUTS}-rollout genmove: launches {launches_b}")
        got, launches_s = gtp_session(
            ["--gtp", "--num-rollout", str(SERVE_ROLLOUTS), "--seed", "0",
             "--weights", "tests/fixtures/sanity_net.json"],
            ["clear_board"] + moves[:SANITY_GENMOVES]
            + ["final_score", "quit"])
        check(launches_s["leaf_step"] >= SERVE_ROLLOUTS * SANITY_GENMOVES
              and launches_s["ladder_planes"] > 0,
              f"sanity-net session: launches {launches_s}")
        sanity_lat = [s for cmd, _, s in got if cmd.startswith("genmove")]
        sanity_score = got[-2][2]
        taken = []
        take = PonderService.take

        def take_and_keep(self, state):
            trees = take(self, state)
            taken.append((trees, None if trees is None
                          else int(trees.node_n[0, 0]), self.last_wait))
            return trees

        PonderService.take = take_and_keep
        try:
            got, launches_p = gtp_session(
                ["--gtp", "--ponder", "--num-rollout", str(SERVE_ROLLOUTS),
                 "--seed", "0"],
                ["clear_board", "play b q16", PONDER_WAIT, "genmove w",
                 "quit"])
        finally:
            PonderService.take = take
        check(len(taken) == 1 and taken[0][0] is not None,
              "genmove did not take the pondered tree")
        trees, pondered, wait = taken[0]
        check(pondered > 1 and int(trees.node_n[0, 0])
              == pondered + SERVE_ROLLOUTS,
              f"pondered visits {pondered}, then "
              f"{int(trees.node_n[0, 0])}")
        check(launches_p["leaf_step"] >= pondered - 1 + SERVE_ROLLOUTS,
              f"ponder session: launches {launches_p}")
        ponder_lat = got[2][2]
        phase("serve", t0, f"128x9 net, genmove at {SERVE_ROLLOUTS} "
              f"rollouts median {statistics.median(lat100):.3f} s "
              f"(min {min(lat100):.3f}, max {max(lat100):.3f}; "
              f"{SERVE_GENMOVES} moves), at {DEEP_ROLLOUTS} "
              f"{lat_deep:.3f} s, "
              f"final_score {score_secs:.3f} s ({score} after "
              f"{len(played) + 1} moves); launches {launches_a} / "
              f"{launches_b}; sanity net: genmove median "
              f"{statistics.median(sanity_lat):.3f} s, final_score "
              f"{sanity_score:.3f} s, launches {launches_s}; ponder: "
              f"{pondered} visits pondered in {PONDER_WAIT} s, take() "
              f"waited {wait:.3f} s, genmove {ponder_lat:.3f} s, "
              f"launches {launches_p}")

        # 3. reanalyze at full width
        t0 = time.monotonic()
        with open(REANALYZE_FILE) as fh:
            games = [next(fh).strip() for _ in range(REANALYZE_GAMES)]
        path = f"{tmp}/games.sgf"
        with open(path, "w") as fh:
            fh.write("\n".join(games) + "\n")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, launches_r, wall = counted(lambda: cli.main(
                ["--reanalyze", path, "--num-rollout", str(SERVE_ROLLOUTS),
                 "--seed", "0"]))
        check(rc == 0, f"reanalyze exited {rc}")
        lines = out.getvalue().splitlines()
        check(len(lines) == len(games), f"{len(lines)} lines reanalyzed of "
              f"{len(games)}")
        patched = 0
        for line, before in zip(lines, games):
            parsed, orig = sgf.parse_line(line), sgf.parse_line(before)
            check(parsed is not None and len(parsed.moves) ==
                  len(orig.moves), f"bad reanalyzed line: {line[:200]}")
            for mv in parsed.moves:
                if mv.num_rollout == SERVE_ROLLOUTS:
                    patched += 1
                    check(mv.policy is not None and mv.policy.shape == (362,)
                          and np.isfinite(mv.policy).all(),
                          f"bad patched move in {line[:200]}")
        check(patched > 0 and launches_r["leaf_step"] >= SERVE_ROLLOUTS,
              f"reanalyze: {patched} positions, launches {launches_r}")
        phase("serve", t0, f"reanalyze of {len(games)} self-play games "
              f"({REANALYZE_FILE}), 128x9 net, {SERVE_ROLLOUTS} "
              f"rollouts: {patched} positions in {wall:.2f} s, "
              f"{patched / wall:.2f} positions/s, launches {launches_r}")

        # the CPU's answers and lines
        t0 = time.monotonic()
        host_answers, host_annotated = on_host.result()
        check(answers == host_answers, "GTP answers on the card differ from "
              "the CPU: " + "; ".join(
                  f"{c!r}: {a.strip()!r} vs {b.strip()!r}" for c, a, b in
                  zip(gtp_script(game), answers, host_answers) if a != b))
        for name, a, b in zip(("reanalyze", "ex-it"), annotated,
                              host_annotated):
            check(a == b, f"{name} lines on the card differ from the CPU")
        phase("serve", t0, f"card == cpu: {len(answers)} GTP answers "
              f"(card {card_secs:.1f} s with reanalyze and ex-it of "
              f"{len(annotated[0])} sample games, "
              f"{SERVE_REF_ROLLOUTS} rollouts), waited "
              f"{time.monotonic() - t0:.1f} s for the CPU")
    phase("serve", t_phase, "GTP and reanalyze")


# ---------------------------------------------------------------------------
# 5b. the trainer


def train_step_reference(device, sd, feats, labels):
    """One float32 train step of a 128 x 9 ``TrainTower`` holding ``sd``,
    on ``feats`` and ``labels``, on ``device``: ``(metrics, gradients,
    state_dict after the step)``, on the CPU."""
    from dream_go_torch.config import ModelConfig, TrainConfig
    from dream_go_torch.models import tower as T
    from dream_go_torch.train import train_loop as TL

    model = T.TrainTower(ModelConfig(compute_dtype="float32"))
    model.load_state_dict(sd)
    model.to(device).train()
    tcfg = TrainConfig(batch_size=feats.shape[0])
    metrics = TL.train_step(
        model, TL.make_optimizer(model, tcfg.initial_lr), tcfg,
        feats.to(device), {k: v.to(device) for k, v in labels.items()},
        tcfg.initial_lr)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad.cpu() for k, p in model.named_parameters()},
            {k: v.cpu() for k, v in model.state_dict().items()})


def step_batch(dev):
    """The B = ``STEP_REF_BATCH`` batch of the float32 step checks, on the
    CPU: a bank of eight rl20 games, augmented."""
    from dream_go_torch.train.pipeline import ExampleSource

    with open(REANALYZE_FILE) as fh:
        lines = [line.strip() for line in fh if line.strip()]
    src = ExampleSource(lines, STEP_REF_BATCH, seed=0, positions_per_game=8,
                        bank_games=8, device=dev)
    feats, labels = next(iter(src.batches(1)))
    return feats.cpu(), {k: v.cpu() for k, v in labels.items()}


def step_sd():
    """The float32 step checks' 128 x 9 weights (seeded), on the CPU."""
    from dream_go_torch.config import ModelConfig
    from dream_go_torch.models import tower as T

    return T.init_train_tower(ModelConfig(), seed=3, device="cpu").state_dict()


def compare_steps(what, got, want) -> str:
    """Hold one float32 train step ``got`` (metrics, gradients, state
    after the step, as :func:`train_step_reference` returns them) against
    ``want``: losses within ``STEP_LOSS_RTOL``, accuracies within one
    example, the gradients within ``STEP_GRAD_RTOL`` in L2 norm over all
    tensors and within ``STEP_TENSOR_RTOL`` in each tensor of at least
    ``STEP_GRAD_MIN_NUMEL`` entries, the new running statistics within
    ``STEP_STATS_RTOL`` and ``STEP_STATS_ATOL``, and the parameters after
    Adam within ``STEP_ADAM_ATOL``; returns the gaps, for the log."""
    import math

    gaps = {}
    for k, v in want[0].items():
        if k.startswith("loss"):
            gaps[k] = abs(got[0][k] - v) / abs(v)
            check(gaps[k] <= STEP_LOSS_RTOL, f"{what} {k}: "
                  f"{got[0][k]!r} against {v!r}")
        else:
            check(abs(got[0][k] - v) <= 1.0 / STEP_REF_BATCH + 1e-6,
                  f"{what} {k}: {got[0][k]!r} against {v!r}")
    diff = {k: float((a - want[1][k]).norm()) for k, a in got[1].items()}
    norm = {k: float(g.norm()) for k, g in want[1].items()}
    grad_gap = math.sqrt(sum(d * d for d in diff.values())
                         / sum(n * n for n in norm.values()))
    worst = max((diff[k] / max(norm[k], 1e-30), k) for k in diff
                if got[1][k].numel() >= STEP_GRAD_MIN_NUMEL)
    check(grad_gap <= STEP_GRAD_RTOL and worst[0] <= STEP_TENSOR_RTOL,
          f"{what} gradients off by {grad_gap:.3e} in all, "
          f"{worst[0]:.3e} in {worst[1]}")
    stats_gap = adam_gap = 0.0
    for k, a in got[2].items():
        b = want[2][k]
        if k.endswith((".mean", ".var")):
            stats_gap = max(stats_gap, float(
                ((a - b).abs() - STEP_STATS_RTOL * b.abs()).max()))
        else:
            adam_gap = max(adam_gap, float((a - b).abs().max()))
    check(stats_gap <= STEP_STATS_ATOL, f"{what} running statistics off by "
          f"{stats_gap:.3e} beyond {STEP_STATS_RTOL} of their value")
    check(adam_gap <= STEP_ADAM_ATOL, f"{what} parameters off by "
          f"{adam_gap:.3e}")
    return (f"loss {got[0]['loss']:.6f} vs {want[0]['loss']:.6f}, "
            "relative loss gaps "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
            + f"; gradients {grad_gap:.2e} in all (limit {STEP_GRAD_RTOL}), "
            f"{worst[0]:.2e} in {worst[1]} (limit {STEP_TENSOR_RTOL}); "
            f"running statistics {stats_gap:.2e} beyond {STEP_STATS_RTOL} "
            f"of their value (limit {STEP_STATS_ATOL}); parameters after "
            f"Adam {adam_gap:.2e} (limit {STEP_ADAM_ATOL})")


def train_step_parity(dev, host):
    """The card's float32 train step (TF32 off) against the CPU's (in
    ``host``, a process of its own) from the same weights and batch,
    within the limits of :func:`compare_steps`."""
    t0 = time.monotonic()
    feats, labels = step_batch(dev)
    sd = step_sd()
    # the host gets copies: pickling a CPU tensor for the worker moves its
    # storage into shared memory on a feeder thread, which would race with
    # this thread's copy of the same tensor to the card
    on_host = host.submit(
        train_step_reference, "cpu", {k: v.clone() for k, v in sd.items()},
        feats.clone(), {k: v.clone() for k, v in labels.items()})
    card = train_step_reference(dev, sd, feats, labels)
    summary = compare_steps("train step", card, on_host.result())
    phase("train", t0, f"card == cpu, one float32 train step at 128 x 9, "
          f"B={STEP_REF_BATCH}: {summary}")


def train_phase(dev, host):
    """The trainer at the CLI's defaults (128 x 9, B = 2048, 8 positions
    a game, a bank of 1024 games) through ``cli.main``: ``--start`` (with
    planes 30/31), ``--resume``, ``--verify`` and ``--dump`` on three
    generations of the rl20 run, then genmoves served from the dumped
    weights; each run with the kernels' launch counts and the native
    loader's calls zeroed before and read after.  Then one train step on
    the card against the CPU's."""
    import contextlib
    import io
    import math
    import shutil
    import statistics

    from dream_go_torch import cli, native
    from dream_go_torch.models import params as MP

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, TRAIN_DIR)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    ckpt, metrics, weights = (os.path.join(out, name) for name in
                              ("ckpt", "metrics.jsonl", "dream_go.json"))
    start, resume, verify = (os.path.join(root, p) for p in TRAIN_DATA)

    def run(name, argv):
        """``cli.main(argv)``: its stdout, its bank's seconds and
        launches; the lines it wrote to stderr are logged."""
        t0 = time.monotonic()
        stdout, stderr = io.StringIO(), io.StringIO()
        native.calls = 0
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            rc, launches, wall = counted(lambda: cli.main(argv))
        check(rc == 0, f"{name}: cli.main exited {rc}")
        for line in stderr.getvalue().splitlines():
            log(f"  {name}: {line}")
        banks = [float(m) for m in re.findall(
            r"example bank: \d+ examples of \d+ games in ([\d.]+) s",
            stderr.getvalue())]
        phase("train", t0, f"{name}: {wall:.2f} s, launches {launches}, "
              f"native loader calls {native.calls}")
        return stdout.getvalue(), banks, launches, native.calls

    def steps_of(records):
        """Median ms between successive steps of one run."""
        t = [r["time"] for r in records]
        return 1e3 * statistics.median(b - a for a, b in zip(t, t[1:]))

    args = cli.build_parser().parse_args(["--start", start])
    check((args.num_channels, args.num_blocks, args.batch_size,
           args.positions_per_game, args.bank_games) ==
          (128, 9, 2048, 8, 1024), "the train phase runs the CLI defaults")
    _, bank_start, launches, calls = run("--start", [
        "--start", start, "--steps", str(TRAIN_STEPS), "--ladder-features",
        "--checkpoint", ckpt, "--metrics", metrics, "--seed", "0"])
    check(launches["ladder_planes"] > 0 and
          launches["board_features_raw"] > 0,
          f"the bank build did not launch K2 and K3: {launches}")
    check(calls > 0, "the native loader was not used")
    _, bank_resume, launches_r, calls_r = run("--resume", [
        "--resume", resume, "--steps", str(RESUME_STEPS),
        "--checkpoint", ckpt, "--metrics", metrics, "--seed", "1"])
    check(launches_r["ladder_planes"] > 0 and calls_r > 0,
          f"--resume: launches {launches_r}, native calls {calls_r}")
    with open(metrics) as fh:
        records = [json.loads(line) for line in fh]
    total = TRAIN_STEPS + RESUME_STEPS
    check([r["step"] for r in records] == list(range(1, total + 1)),
          f"metrics steps {[r['step'] for r in records]}")
    check(all(math.isfinite(r[k]) for r in records for k in r),
          "a non-finite metric")
    verified, bank_verify, launches_v, _ = run("--verify", [
        "--verify", verify, "--checkpoint", ckpt, "--seed", "2"])
    verified = json.loads(verified)
    check(all(math.isfinite(v) for v in verified.values()),
          f"--verify: {verified}")
    dumped, _, _, _ = run("--dump", ["--dump", "--checkpoint", ckpt])
    with open(weights, "w") as fh:
        fh.write(dumped)
    cfg, _ = MP.load_json(dumped)
    check((cfg.num_channels, cfg.num_blocks, cfg.ladder_features) ==
          (128, 9, True), f"the dumped net is {cfg}")
    t0 = time.monotonic()
    got, launches_g = gtp_session(
        ["--gtp", "--num-rollout", str(TRAIN_ROLLOUTS), "--seed", "0",
         "--weights", weights],
        ["clear_board"] + [f"genmove {'bw'[i % 2]}"
                           for i in range(TRAIN_GENMOVES)] + ["quit"])
    check(launches_g["leaf_step"] >= TRAIN_ROLLOUTS * TRAIN_GENMOVES
          and launches_g["ladder_planes"] > 0,
          f"genmoves from the dumped weights: launches {launches_g}")
    phase("train", t0, f"the dumped weights serve: "
          f"{[t for c, t, _ in got if c.startswith('genmove')]}, "
          f"launches {launches_g}")
    ms = [steps_of(records[:TRAIN_STEPS]), steps_of(records[TRAIN_STEPS:])]
    phase("train", t_phase, f"128x9, B=2048, banks of 1024 games x 8 "
          f"positions built in {bank_start + bank_resume + bank_verify} s; "
          f"a step {ms[0]:.2f} ms (--start, median of {TRAIN_STEPS - 1}), "
          f"{ms[1]:.2f} ms (--resume, median of {RESUME_STEPS - 1}): "
          f"{2048e3 / ms[0]:.0f} / {2048e3 / ms[1]:.0f} examples/s; loss "
          f"{records[0]['loss']:.4f} at step 1, "
          f"{records[TRAIN_STEPS - 1]['loss']:.4f} at {TRAIN_STEPS}, "
          f"{records[-1]['loss']:.4f} at {total}; --verify loss "
          f"{verified['loss']:.4f}, top1 {verified['policy_top1']:.4f}; "
          f"launches --start {launches}, --resume {launches_r}, --verify "
          f"{launches_v}")
    train_step_parity(dev, host)


# ---------------------------------------------------------------------------
# 5c. the RL loop and distillation

LOOP_MOVE_RE = re.compile(r";([BW])\[(?:[a-s]{2})?\](?:TV\[(\d+)\]"
                          r"P\[([^\]]+)\])?V\[(-?\d\.\d{4})\]")
LOOP_SGF_RE = re.compile(
    r"^\(;GM\[1\]FF\[4\]DT\[[^\]]*\]SZ\[19\]RU\[Chinese\]KM\[-?\d+\.\d\]"
    r"RE\[(?:[BW]\+\d+\.\d|0)\]"
    r"((?:;[BW]\[(?:[a-s]{2})?\](?:TV\[\d+\]P\[[^\]]+\])?V\[-?\d\.\d{4}\])+)"
    r"(?:TB(?:\[[a-s]{2}\])+)?(?:TW(?:\[[a-s]{2}\])+)?\)$")


def check_loop_sgf(line: str, rollouts: int) -> tuple[int, int]:
    """Raise unless ``line`` is a well-formed record of the loop's actor:
    policy-play moves (``V[...]``) and ex-it moves (``TV[n]P[...]V[...]``,
    ``n`` at most ``rollouts``); returns (moves, ex-it moves)."""
    m = LOOP_SGF_RE.match(line)
    check(m, f"malformed SGF line: {line[:200]}")
    moves = LOOP_MOVE_RE.findall(m.group(1))
    searched = 0
    for i, (color, tv, blob, value) in enumerate(moves):
        check(color == "BW"[i % 2] and -1.0 <= float(value) <= 1.0,
              f"bad move {i} in SGF line: {line[:200]}")
        if tv:
            policy = np.frombuffer(base64.b85decode(blob), np.float16)
            check(1 < int(tv) <= rollouts and policy.shape == (362,)
                  and np.isfinite(policy).all()
                  and abs(float(policy.astype(np.float32).sum()) - 1.0)
                  < 0.02, f"bad ex-it move {i} in SGF line: {line[:200]}")
            searched += 1
    return len(moves), searched


def cli_run(name, argv):
    """``cli.main(argv)`` with stdout and stderr captured and the launch
    counts zeroed before and read after: ``(stderr lines, launches,
    seconds)``; the stderr lines are logged."""
    import contextlib
    import io

    from dream_go_torch import cli

    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        rc, launches, wall = counted(lambda: cli.main(argv))
    check(rc == 0, f"{name}: cli.main exited {rc}")
    lines = stderr.getvalue().splitlines()
    for line in lines:
        log(f"  {name}: {line}")
    return lines, launches, wall


def loop_phase(dev):
    """The closed RL loop through ``cli.main`` at the CLI's width and
    batch: ``--loop 2 --ex-it --ladder-features``, then ``--loop 3
    --resume-loop --warm-restart`` on the same directory; each run with
    the launch counts zeroed before and read after."""
    import math
    import shutil

    from dream_go_torch import cli
    from dream_go_torch.train.train_loop import Trainer

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, LOOP_DIR)
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--out-dir", out, "--ex-it", "--ladder-features",
            "--num-games", str(LOOP_GAMES), "--num-rollout",
            str(LOOP_ROLLOUTS), "--max-moves", str(LOOP_MOVES),
            "--bank-games", str(LOOP_BANK), "--steps-per-gen",
            str(LOOP_STEPS), "--seed", "0"]
    args = cli.build_parser().parse_args(["--loop", "2", *argv])
    check((args.num_channels, args.num_blocks, args.batch_size,
           args.positions_per_game) == (128, 9, 2048, 8),
          "the loop phase runs the CLI's width and batch")
    first, launches, wall = cli_run("--loop 2", ["--loop", "2", *argv])
    phase("loop", t_phase, f"--loop 2: {wall:.2f} s, launches {launches}")
    t0 = time.monotonic()
    second, launches_r, wall_r = cli_run(
        "--loop 3 --resume-loop", ["--loop", "3", "--resume-loop",
                                   "--warm-restart", *argv])
    phase("loop", t0, f"--loop 3 --resume-loop --warm-restart: "
          f"{wall_r:.2f} s, launches {launches_r}")
    stopped = any("learning rate floor reached" in m for m in first + second)

    for gen in range(3):
        for name in (f"gen_{gen:04d}.sgf", f"ckpt_{gen:04d}",
                     f"weights_{gen:04d}.json"):
            check(os.path.exists(os.path.join(out, name)),
                  f"the loop wrote no {name}")
        with open(os.path.join(out, f"gen_{gen:04d}.sgf")) as fh:
            lines = [line.strip() for line in fh if line.strip()]
        check(len(lines) == LOOP_GAMES, f"gen {gen}: {len(lines)} games")
        counts = [check_loop_sgf(line, LOOP_ROLLOUTS) for line in lines]
        log(f"  gen {gen}: {sum(c[0] for c in counts)} moves, "
            f"{sum(c[1] for c in counts)} re-searched by ex-it")
    check(os.path.exists(os.path.join(out, "dream_go.json")),
          "the loop wrote no dream_go.json")
    steps = [Trainer.restore(os.path.join(out, f"ckpt_{g:04d}"),
                             device=dev).step for g in (1, 2)]
    check(stopped or steps == [2 * LOOP_STEPS, 3 * LOOP_STEPS],
          f"steps after the runs: {steps}")
    check(any("resume: generation 2 from ckpt_0001" in m for m in second)
          and any("warm restart" in m for m in second),
          "the resume and warm-restart lines are missing")
    losses = [float(m) for m in re.findall(
        r"gen \d+: loss (\S+)", "\n".join(first + second))]
    check(len(losses) == 3 and all(math.isfinite(v) for v in losses),
          f"losses {losses}")
    for k in ("leaf_step", "ladder_planes", "board_features_raw"):
        check(launches[k] + launches_r[k] > 0,
              f"the loop never launched {k}: {launches}, {launches_r}")
    check(launches["env_step"] == 0 and launches_r["env_step"] == 0,
          "the loop launched env_step")
    t0 = time.monotonic()
    got, launches_g = gtp_session(
        ["--gtp", "--num-rollout", str(TRAIN_ROLLOUTS), "--seed", "0",
         "--weights", os.path.join(out, "weights_0002.json")],
        ["clear_board", "genmove b", "quit"])
    check(launches_g["leaf_step"] >= TRAIN_ROLLOUTS,
          f"genmove from weights_0002.json: launches {launches_g}")
    phase("loop", t0, f"weights_0002.json serves: {got[1][1]!r} in "
          f"{got[1][2]:.2f} s, launches {launches_g}")
    parts = {}
    for line in first + second:
        if m := re.search(r"gen (\d+): .*\[play ([\d.]+)s, ex-it "
                          r"([\d.]+)s\]", line):
            parts.setdefault(int(m.group(1)), []).extend(
                float(x) for x in m.groups()[1:])
        elif m := re.search(r"gen (\d+): loss .*\[bank ([\d.]+)s, train "
                            r"([\d.]+)s\]", line):
            parts.setdefault(int(m.group(1)), []).extend(
                float(x) for x in m.groups()[1:])
    check(sorted(parts) == [0, 1, 2] and all(len(v) == 4
                                             for v in parts.values()),
          f"generation timings {parts}")
    phase("loop", t_phase, f"128x9, B=2048, {LOOP_GAMES} games x "
          f"{LOOP_MOVES} moves a generation, ex-it at {LOOP_ROLLOUTS} "
          f"rollouts, banks of {LOOP_BANK} games, {LOOP_STEPS} steps a "
          f"generation; steps {steps}; losses {losses}; seconds a "
          f"generation (play / ex-it / bank / train): " + "; ".join(
              f"gen {g} {' / '.join(f'{x:.2f}' for x in v)}"
              for g, v in sorted(parts.items()))
          + f"; launches {launches} + {launches_r}")


def teacher_weights():
    """The distill phase's random teacher: ``random_weights`` at 192 x 15,
    each conv kernel rescaled to a variance of 2 / fan-in (the second of
    each block to a quarter of that scale), so that 31 layers keep its
    activations in range."""
    from dream_go_torch.models import leela_zero as LZ

    w = LZ.random_weights(DISTILL_FILTERS, DISTILL_BLOCKS, seed=0)

    def scale(p, fan_in, gain=1.0):
        k = p["kernel"]
        p["kernel"] = k * np.float32(
            gain * np.sqrt(2.0 / (k.shape[0] ** 2 * fan_in)) / 0.1)

    scale(w["input"], 18)
    for c1, c2 in w["blocks"]:
        scale(c1, DISTILL_FILTERS)
        scale(c2, DISTILL_FILTERS, 0.25)
    scale(w["policy_conv"], DISTILL_FILTERS)
    scale(w["value_conv"], DISTILL_FILTERS)
    return w


def distill_phase(dev):
    """Leela-zero distillation: the teacher's file written and parsed,
    its card outputs held against the CPU's on 8 positions, then
    ``--start gen_0047.sgf --lz-weights`` through ``cli.main`` with the
    launch counts zeroed before and read after; every loss finite and
    ``has_ownership`` all zero; the per-batch replay and teacher timed."""
    import math
    import shutil
    import statistics

    from dream_go_torch.models import leela_zero as LZ
    from dream_go_torch.train.distill import DistillationSource
    from dream_go_torch.train.pipeline import ExampleSource

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, DISTILL_DIR)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    path = os.path.join(out, "lz.txt")
    w = teacher_weights()
    t0 = time.monotonic()
    LZ.save_weights(w, path)
    t_write = time.monotonic() - t0
    t0 = time.monotonic()
    loaded = LZ.load_weights(path)
    t_parse = time.monotonic() - t0
    check((loaded["channels"], loaded["num_blocks"]) ==
          (DISTILL_FILTERS, DISTILL_BLOCKS), "the teacher file's shape")
    phase("distill", t_phase, f"teacher {DISTILL_FILTERS} x "
          f"{DISTILL_BLOCKS}: {os.path.getsize(path) / 1e6:.1f} MB written "
          f"in {t_write:.2f} s, parsed in {t_parse:.2f} s")

    data = os.path.join(root, TRAIN_DATA[2])
    with open(data) as fh:
        lines = [line.strip() for line in fh if line.strip()]
    t0 = time.monotonic()
    probe = ExampleSource(lines, 8, seed=3, augment=False, lz_history=True,
                          device=dev)
    _, labels = next(iter(probe.batches(1)))
    lz = labels["lz_features"]
    card = LZ.teacher(loaded, dev)
    v, p = card(lz)
    torch.cuda.synchronize()
    v32, p32 = LZ.teacher(loaded, "cpu")(lz.cpu())
    dv = float((v.cpu() - v32).abs().max())
    dp = float((p.cpu() - p32).abs().max())
    check(dv <= TEACHER_VALUE_ATOL and dp <= TEACHER_POLICY_ATOL,
          f"card teacher vs cpu: value {dv:.3e}, policy {dp:.3e}")
    check(float(v32.abs().max()) < 0.999 and float(p32.max()) < 0.5,
          "the teacher saturates")
    phase("distill", t0, f"card teacher == cpu on 8 positions: max "
          f"|value| {dv:.3e} (limit {TEACHER_VALUE_ATOL}), max |policy| "
          f"{dp:.3e} (limit {TEACHER_POLICY_ATOL}); values "
          f"{[round(x, 4) for x in v32.tolist()]}")

    ckpt, metrics = (os.path.join(out, n) for n in ("ckpt", "m.jsonl"))
    t0 = time.monotonic()
    _, launches, wall = cli_run("--start --lz-weights", [
        "--start", data, "--lz-weights", path, "--steps",
        str(DISTILL_STEPS), "--checkpoint", ckpt, "--metrics", metrics,
        "--seed", "0"])
    with open(metrics) as fh:
        records = [json.loads(line) for line in fh]
    check([r["step"] for r in records] ==
          list(range(1, DISTILL_STEPS + 1)), "distill metrics steps")
    check(all(math.isfinite(r[k]) for r in records for k in r),
          "a non-finite distill metric")
    check(launches["board_features_raw"] > 0,
          f"the distill batches did not launch K3: {launches}")
    t = [r["time"] for r in records]
    step_ms = 1e3 * statistics.median(b - a for a, b in zip(t, t[1:]))
    phase("distill", t0, f"--start --lz-weights, {DISTILL_STEPS} steps: "
          f"{wall:.2f} s, a step {step_ms:.1f} ms (median of "
          f"{DISTILL_STEPS - 1}), losses "
          f"{[round(r['loss'], 4) for r in records]}, launches {launches}")

    source = ExampleSource(lines, 2048, seed=4, lz_history=True, device=dev)
    distilled = DistillationSource(source, loaded)
    t1 = time.monotonic()
    _, lab = next(iter(distilled.batches(1)))
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.monotonic() - t1)
    t1 = time.monotonic()
    next(iter(source.batches(1)))
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.monotonic() - t1)
    check(float(lab["has_ownership"].abs().max()) == 0.0,
          "distilled labels keep ownership")
    check(bool(torch.isfinite(lab["value"]).all())
          and float((lab["policy"].sum(-1) - 1).abs().max()) < 1e-4,
          "distilled labels are not finite distributions")
    lz = torch.zeros(2048, 19, 19, 18, device=dev)
    teacher_ms = events_ms(lambda: distilled.teacher(lz), 1)
    phase("distill", t_phase, f"{DISTILL_FILTERS}x{DISTILL_BLOCKS} teacher: "
          f"file {t_write:.2f} s written, {t_parse:.2f} s parsed; a step "
          f"{step_ms:.1f} ms; a distilled batch of 2048 examples "
          f"{batch_ms:.1f} ms (the first, its replay cold), then a "
          f"per-batch replay of 2048 games with the planes "
          f"{replay_ms:.1f} ms and the teacher alone {teacher_ms:.1f} ms")


# ---------------------------------------------------------------------------
# 5e. the mesh and the tools


def run_group(name, argv, timeout):
    """``argv`` (a process that starts ranks) in a session of its own,
    from the repository's root; all of its processes are killed when it
    outlasts ``timeout`` seconds: ``(stderr lines, seconds)``, the lines
    logged.  Raises unless it exits 0."""
    import signal

    t0 = time.monotonic()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        check(False, f"{name}: killed after {timeout:.0f} s: {err[-3000:]}")
    lines = err.splitlines()
    for line in lines:
        if "socket.cpp" not in line:
            log(f"  {name}: {line}")
    check(proc.returncode == 0, f"{name}: exited {proc.returncode}")
    return lines, time.monotonic() - t0


def mesh_step_rank(rank: int, sd, feats, labels, out: str,
                   device: str) -> None:
    """One rank of the mesh phase's float32 step: world 2 on the card,
    data = 2, then model = 2; rank 0 saves both steps, whole, as
    :func:`train_step_reference` returns them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dream_go_torch.config import ModelConfig, TrainConfig
    from dream_go_torch.models import tower as T
    from dream_go_torch.parallel import distributed as D
    from dream_go_torch.parallel import mesh as M
    from dream_go_torch.train import lr_schedule as LR
    from dream_go_torch.train import train_loop as TL

    dev = D.initialize(device)
    tcfg = TrainConfig(batch_size=feats.shape[0])
    steps = {}
    for model_ranks in (1, 2):
        mesh = M.make_mesh(model=model_ranks)
        model = T.TrainTower(ModelConfig(compute_dtype="float32"))
        model.load_state_dict(sd)
        model.to(dev).train()
        trainer = TL.Trainer(
            model.cfg, tcfg, model, TL.make_optimizer(model, tcfg.initial_lr),
            LR.LearningRateScheduler(tcfg.initial_lr, tcfg.lr_decay))
        trainer.shard_over(mesh)
        rows = mesh.local_rows(feats.shape[0])
        metrics = TL.train_step(
            trainer.model, trainer.optimizer, tcfg, feats[rows].to(dev),
            {k: v[rows].to(dev) for k, v in labels.items()},
            tcfg.initial_lr, mesh)
        steps[model_ranks] = (
            {k: float(v) for k, v in metrics.items()},
            {k: trainer._whole(k, p.grad).cpu()
             for k, p in trainer.model.named_parameters()},
            {k: v.cpu() for k, v in trainer.state_dict().items()})
        if model_ranks == 1:
            timing = step_timing(dev, M.make_mesh())
    if rank == 0:
        torch.save({"steps": steps, "timing": timing}, out)
    D.shutdown()


def timing_batch(dev, b: int):
    """Random planes and labels of ``b`` examples on ``dev`` (for timing
    only)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = (torch.rand(b, 19, 19, 32, generator=gen, device=dev) < 0.3
             ).float()
    policy = torch.rand(b, 362, generator=gen, device=dev)
    sign = lambda *shape: torch.randint(  # noqa: E731
        0, 2, shape, generator=gen, device=dev).float() * 2 - 1
    return feats, {"policy": policy / policy.sum(-1, keepdim=True),
                   "value": sign(b), "ownership": sign(b, 361),
                   "has_ownership": torch.ones(b, device=dev)}


def step_ms(dev, mesh=None) -> float:
    """The mean ms of ``MESH_TIMED_STEPS`` bf16 train steps of the
    128 x 9 tower at B = 2048 (this rank's rows on a ``mesh``), after
    three warm-up steps."""
    from dream_go_torch.config import ModelConfig, TrainConfig
    from dream_go_torch.models import tower as T
    from dream_go_torch.train import train_loop as TL

    tcfg = TrainConfig()
    model = T.init_train_tower(ModelConfig(), seed=3, device=dev)
    opt = TL.make_optimizer(model, tcfg.initial_lr)
    if mesh is not None:
        model.shard_over(mesh)
        opt = TL.make_optimizer(model, tcfg.initial_lr)
    rows = slice(None) if mesh is None else mesh.local_rows(
        tcfg.batch_size)
    feats, labels = timing_batch(dev, tcfg.batch_size)
    feats, labels = feats[rows], {k: v[rows] for k, v in labels.items()}

    def step():
        metrics = TL.train_step(model, opt, tcfg, feats, labels,
                                tcfg.initial_lr, mesh)
        torch.stack(list(metrics.values())).tolist()  # as fit reads them

    for _ in range(3):
        step()
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    for _ in range(MESH_TIMED_STEPS):
        step()
    torch.cuda.synchronize(dev)
    return 1000 * (time.monotonic() - t0) / MESH_TIMED_STEPS


def step_timing(dev, mesh) -> dict:
    """Where a two-rank step's time goes: a bf16 step at B = 2048 (1024
    a rank), one small all-reduce as the batch norms make (``[2, 128]``
    float32) and one of every gradient (3.7 M float32), each in ms, both
    ranks at once on the shared card."""
    import torch.distributed as dist

    from dream_go_torch.config import ModelConfig
    from dream_go_torch.models import tower as T

    n = sum(p.numel() for p in T.TrainTower(ModelConfig()).parameters())
    out = {"step_ms": step_ms(dev, mesh), "grad_numel": n}
    for name, x, reps in (("stats", torch.ones(2, 128, device=dev),
                           MESH_TIMED_REDUCES),
                          ("grads", torch.ones(n, device=dev),
                           MESH_TIMED_STEPS)):
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        for _ in range(reps):
            dist.all_reduce(x, group=mesh.data_group)
        torch.cuda.synchronize(dev)
        out[f"{name}_reduce_ms"] = 1000 * (time.monotonic() - t0) / reps
    return out


def mesh_phase(dev):
    """The RL loop over two ranks sharing the card (``torchrun ... --loop 1
    --mesh``), one float32 train step on two ranks against one, the
    multi-device dry run over NCCL, and ``entry()`` on the card."""
    import math
    import shutil

    from dream_go_torch import entry
    from dream_go_torch.parallel import distributed as D
    from dream_go_torch.train.train_loop import Trainer

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, MESH_DIR)
    shutil.rmtree(out, ignore_errors=True)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(MESH_RANKS), "-m", "dream_go_torch.cli",
            "--loop", "1", "--mesh", "--ex-it", "--ladder-features",
            "--out-dir", out, "--num-games", str(LOOP_GAMES),
            "--num-rollout", str(LOOP_ROLLOUTS), "--max-moves",
            str(LOOP_MOVES), "--bank-games", str(LOOP_BANK),
            "--steps-per-gen", str(LOOP_STEPS), "--seed", "0",
            "--device", dev.type]
    lines, wall = run_group("--loop 1 --mesh", argv, MESH_LOOP_TIMEOUT)
    text = "\n".join(lines)
    check(f"mesh: {{'data': {MESH_RANKS}, 'model': 1}}" in text,
          "the mesh line is missing")
    check(text.count("backend gloo") == MESH_RANKS,
          "the ranks sharing the card did not all take gloo")
    launches = {}
    # the ranks write to one pipe, so their lines may interleave
    for m in re.finditer(r"rank \d+ of \d+: kernel launches (\{[^}]*\})",
                         text):
        for k, v in json.loads(m.group(1)).items():
            launches[k] = launches.get(k, 0) + v
    check(len(re.findall(r"kernel launches", text)) == MESH_RANKS,
          "a rank printed no launch counts")
    for k in ("leaf_step", "ladder_planes", "board_features_raw",
              "select_walk"):
        check(launches.get(k, 0) > 0, f"the mesh loop never launched {k}: "
              f"{launches}")
    with open(os.path.join(out, "gen_0000.sgf")) as fh:
        games = [line.strip() for line in fh if line.strip()]
    check(len(games) == LOOP_GAMES, f"the mesh loop wrote {len(games)} "
          f"games, not {LOOP_GAMES}")
    counts = [check_loop_sgf(line, LOOP_ROLLOUTS) for line in games]
    check(os.path.exists(os.path.join(out, "weights_0000.json")),
          "the mesh loop wrote no weights_0000.json")
    step = Trainer.restore(os.path.join(out, "ckpt_0000"), device=dev).step
    check(step == LOOP_STEPS, f"the mesh loop's checkpoint is at step {step}")
    loss = [float(x) for x in re.findall(r"gen 0: loss (\S+)", text)]
    check(len(loss) == 1 and math.isfinite(loss[0]), f"losses {loss}")
    parts = re.findall(r"\[play ([\d.]+)s, ex-it ([\d.]+)s\]", text) + \
        re.findall(r"\[bank ([\d.]+)s on each of \d+ ranks, train "
                   r"([\d.]+)s\]", text)
    phase("mesh", t_phase,
          f"--loop 1 --mesh on {MESH_RANKS} ranks sharing the card, 128x9, "
          f"B=2048 ({2048 // MESH_RANKS} a rank), {LOOP_GAMES} games x "
          f"{LOOP_MOVES} moves ({sum(c[0] for c in counts)} moves, "
          f"{sum(c[1] for c in counts)} re-searched by ex-it), step {step}, "
          f"loss {loss[0]:.4f}; seconds (play, ex-it), (bank, train): "
          f"{parts}; wall {wall:.1f} s; launches summed over the ranks "
          f"{launches}")

    t0 = time.monotonic()
    feats, labels = step_batch(dev)
    sd = step_sd()
    one = train_step_reference(dev, sd, feats, labels)
    path = os.path.join(out, "steps.pt")
    D.spawn(mesh_step_rank, MESH_RANKS,
            ({k: v.clone() for k, v in sd.items()}, feats.clone(),
             {k: v.clone() for k, v in labels.items()}, path, dev.type),
            timeout=MESH_TIMEOUT)
    saved = torch.load(path)
    steps, timing = saved["steps"], saved["timing"]
    for model_ranks in (1, 2):
        summary = compare_steps(f"world 2, model {model_ranks}",
                                steps[model_ranks], one)
        phase("mesh", t0, f"world {MESH_RANKS} (data "
              f"{MESH_RANKS // model_ranks}, model {model_ranks}) == world "
              f"1, one float32 train step at 128 x 9, B={STEP_REF_BATCH}: "
              f"{summary}")

    one_ms = step_ms(dev)
    bn_layers = 3 + 2 * 9  # upsample, the blocks' two, the two heads'
    phase("mesh", t0, f"a bf16 step at 128 x 9, B=2048: world 1 "
          f"{one_ms:.2f} ms, world {MESH_RANKS} sharing the card "
          f"{timing['step_ms']:.2f} ms; one all-reduce of a batch norm's "
          f"statistics {timing['stats_reduce_ms']:.3f} ms (x "
          f"{2 * bn_layers} a step, forward and backward: "
          f"{2 * bn_layers * timing['stats_reduce_ms']:.1f} ms), of the "
          f"{timing['grad_numel']} gradients "
          f"{timing['grads_reduce_ms']:.2f} ms (gloo, through the host)")

    t0 = time.monotonic()
    fn, (x,) = entry.entry(dev.type)
    fn32, _ = entry.entry("cpu")
    planes = torch.from_numpy((np.random.default_rng(0).random(
        tuple(x.shape)) < 0.3).astype(np.float32))
    limits = (BF16_VALUE_ATOL, BF16_POLICY_ATOL, BF16_POLICY_KL)
    for name, inp in (("zeros", x.cpu()), ("random planes", planes)):
        logits, value, _ = fn(inp.to(dev))
        logits32, value32, _ = fn32(inp)
        check(next(fn.model.parameters()).dtype == torch.bfloat16
              and torch.isfinite(logits).all(), "entry() on the card")
        gaps = bf16_gaps((value + 1) / 2, torch.softmax(logits.float(), -1),
                         (value32 + 1) / 2, torch.softmax(logits32, -1))
        check(all(g <= lim for g, lim in zip(gaps, limits)),
              f"entry() on {name}: bf16 off float32 by {gaps}")
        phase("mesh", t0, f"entry() 128x9 at B=16 on {name}: bf16 on the "
              f"card vs fp32 on the CPU max |dv|, |dp|, KL {gaps} (limits "
              f"{limits})")
    phase("mesh", t_phase, "the mesh phase")
    return launches


def dryrun_check(dev):
    """``dryrun_multichip(1)``: one spawned rank on the card, over NCCL,
    JAX's two tiny generations (run beside the reference phase, which
    times nothing: its rank is host-bound, and its launches are counted
    in its own process)."""
    from dream_go_torch import entry
    from dream_go_torch.parallel import distributed as D

    t0 = time.monotonic()
    backend = D.backend_for(dev, 1)
    check(backend[0] == "nccl", f"one rank on the card takes {backend}")
    entry.dryrun_multichip(1, dev.type)
    phase("mesh", t0, f"dryrun_multichip(1) over {backend[0]} "
          f"({backend[1]}): both generations, beside the reference "
          f"phase")


def tool_run(name, main, argv):
    """``main(argv)`` with stdout and stderr captured and the launch counts
    zeroed before and read after: ``(stdout lines, launches, seconds)``;
    the stderr lines are logged."""
    import contextlib
    import io

    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr):
        rc, launches, wall = counted(lambda: main(argv))
    check(rc == 0, f"{name} exited {rc}")
    for line in stderr.getvalue().splitlines():
        log(f"  {name}: {line}")
    return stdout.getvalue().splitlines(), launches, wall


def tools_phase(dev):
    """The tools at 128 x 9 on the card: the arena over the loop phase's
    three planes-on generations (policy play, then search play), the
    accuracy of ``weights_0002.json`` on the sample games, supervised
    training, and ``sgf2score`` (card == CPU)."""
    import math

    from dream_go_torch.tools import (arena, eval_accuracy, sgf2score,
                                      train_supervised)

    t_phase = time.monotonic()
    root = os.path.dirname(os.path.abspath(__file__))
    loop = os.path.join(root, LOOP_DIR)
    total = {}
    for what, extra, games in (
            ("policy", ["--max-moves", str(ARENA_MOVES)], ARENA_GAMES),
            ("search", ["--rollouts", str(ARENA_ROLLOUTS), "--max-moves",
                        str(ARENA_SEARCH_MOVES)], ARENA_SEARCH_GAMES)):
        out, launches, wall = tool_run(
            f"arena ({what})", arena.main,
            [loop, "--games", str(games), "--seed", "0", "--device",
             dev.type, *extra])
        line = json.loads(out[-1])
        check(sorted(line["elo"]) == ["gen0000", "gen0001", "gen0002"]
              and line["games"] == 3 * games, f"arena ({what}): {line}")
        check(launches["ladder_planes"] > 0 and (
            what == "policy" or launches["leaf_step"] > 0),
            f"arena ({what}) launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        phase("tools", t_phase, f"arena, {what} play, 3 planes-on 128x9 "
              f"generations x {games} games a pair, cut at {extra[-1]} "
              f"moves: {line}, {wall:.2f} s, launches {launches}")
    t0 = time.monotonic()
    out, launches, wall = tool_run(
        "eval_accuracy", eval_accuracy.main,
        [os.path.join(loop, "weights_0002.json"), "--device", dev.type])
    row = json.loads(out[0])
    check(row["examples"] == 48 and all(
        0.0 <= row[k] <= 1.0 for k in ("top1", "top3", "top5",
                                       "value_sign")), f"eval_accuracy {row}")
    phase("tools", t0, f"eval_accuracy of weights_0002.json: {row}, "
          f"{wall:.2f} s, launches {launches}")
    t0 = time.monotonic()
    metrics = os.path.join(root, MESH_DIR, "supervised.jsonl")
    _, launches, wall = tool_run(
        "train_supervised", train_supervised.main,
        ["--steps", str(SUPERVISED_STEPS), "--eval-every",
         str(SUPERVISED_STEPS), "--eval-batches", "2", "--batch",
         str(SUPERVISED_BATCH), "--bank-games", str(SUPERVISED_BANK),
         "--metrics", metrics, "--device", dev.type])
    with open(metrics) as fh:
        rows = [json.loads(line) for line in fh]
    check([(r["step"], r["split"]) for r in rows] ==
          [(SUPERVISED_STEPS, "train"), (SUPERVISED_STEPS, "holdout")]
          and all(math.isfinite(r["loss"]) for r in rows),
          f"train_supervised rows {rows}")
    check(launches["board_features_raw"] > 0,
          f"train_supervised launches {launches}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    phase("tools", t0, f"train_supervised, {SUPERVISED_STEPS} steps at "
          f"128x9, batch {SUPERVISED_BATCH}, banks of {SUPERVISED_BANK} "
          f"games: "
          f"{wall:.2f} s ({1000 * wall / SUPERVISED_STEPS:.1f} ms a step "
          f"with its evaluation), holdout loss {rows[1]['loss']}, launches "
          f"{launches}")
    t0 = time.monotonic()
    with open(REANALYZE_FILE) as fh:
        lines = [line.strip() for line in fh if line.strip()]
    card = sgf2score.rescore(lines, dev)
    check(card == sgf2score.rescore(lines, "cpu") and card != lines,
          "sgf2score: the card's lines differ from the CPU's")
    phase("tools", t0, f"sgf2score of {len(lines)} games: card == cpu, "
          f"results {[re.search(r'RE.([^]]*)', l).group(1) for l in card]}")
    more_tools(dev, total)
    phase("tools", t_phase, "the tools phase")
    return total


def more_tools(dev, total):
    """The port's other tools on the card, each cut in depth, launch
    counts zeroed before and read after and added to ``total``: the
    ladder kernel against the recursive oracle, the GTP fuzzer, sustained
    self-play, the in-loop ablation, the ladder planes' cost (alone and
    in the search), repeated leaf evaluations, greedy against exact
    ladders, a tuning match, and ``sgf2array`` (card == CPU)."""
    import io
    import tempfile

    from dream_go_torch.tools import (bench_selfplay, fuzz2gtp,
                                      ladder_differential, measure_eval_dupes,
                                      measure_ladder_cost,
                                      measure_ladder_greedy, profile_flat,
                                      profile_ladder, sgf2array, tune)

    d = ["--device", dev.type]
    runs = [
        ("ladder_differential", ladder_differential.main,
         ["--positions", str(DIFF_POSITIONS)], ("ladder_planes",)),
        ("fuzz2gtp", fuzz2gtp.main, ["--moves", str(FUZZ_MOVES)],
         ("leaf_step",)),
        ("bench_selfplay", bench_selfplay.main,
         ["--batch", str(SPB_BATCH), "--rollout", str(SPB_ROLLOUTS),
          "--games", str(SPB_GAMES), "--warmup-games", str(SPB_RAMP),
          "--max-moves", str(SPB_MOVES), "--ladder-features"],
         ("leaf_step", "ladder_planes")),
        ("profile_flat", profile_flat.main,
         ["--batch", str(FLAT_BATCH), "--sims", str(FLAT_SIMS), "--repeat",
          str(FLAT_REPEAT)], ("leaf_step", "board_features_raw")),
        ("profile_ladder", profile_ladder.main,
         ["--skip-search", "--repeats", str(PLADDER_REPEATS)],
         ("ladder_planes",)),
        ("measure_ladder_cost", measure_ladder_cost.main,
         ["--batch", str(LCOST_BATCH), "--sims", str(LCOST_SIMS), "--reps",
          str(LCOST_REPS)], ("leaf_step", "ladder_planes")),
        ("measure_eval_dupes", measure_eval_dupes.main,
         ["--sims", str(DUPES_SIMS)], ("leaf_step",)),
        ("measure_ladder_greedy", measure_ladder_greedy.main,
         ["--points", str(GREEDY_POINTS)], ("ladder_planes",)),
        ("tune", tune.main,
         ["--rounds", "1", "--games", str(TUNE_GAMES), "--sims",
          str(TUNE_SIMS), "--max-moves", str(TUNE_MOVES)], ("leaf_step",)),
    ]
    results = {}
    for name, main, argv, expect in runs:
        out, launches, wall = tool_run(name, main, argv + d)
        for k in expect:
            check(launches[k] > 0, f"{name} never launched {k}: {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        results[name] = out
        phase("tools", time.monotonic() - wall,
              f"{name} {' '.join(argv)}: {out[-1]}, launches {launches}")
    diff = json.loads(results["ladder_differential"][-1])
    check(diff["positions"] == DIFF_POSITIONS
          and diff["disagree_rate"] <= 0.001 and diff["total_points"] > 0,
          f"ladder_differential: {diff}")
    log(f"  ladder_differential: {diff['total_disagree']} of "
        f"{diff['total_points']} candidate points disagree "
        f"({diff['disagree_rate']:.6f}); the oracle's games "
        f"{diff['play_seconds']} s, the replay and K2 "
        f"{diff['planes_seconds']} s, the oracle's readings "
        f"{diff['oracle_seconds']} s")
    check(json.loads(results["fuzz2gtp"][-1])["failures"] == 0,
          "fuzz2gtp: a malformed answer")
    spb = json.loads(results["bench_selfplay"][-1])
    check(spb["games"] == SPB_GAMES + SPB_RAMP and spb["sims"] > 0
          and spb["ladder_features"], f"bench_selfplay: {spb}")
    flat = json.loads(results["profile_flat"][-1])
    check(all(flat[k] > 0 for k in profile_flat.VARIANTS),
          f"profile_flat: {flat}")
    check(re.match(r"UCT_EXP=[\d.]+ \(winrate [\d.]+ vs baseline\)$",
                   results["tune"][-1]), f"tune: {results['tune'][-1]}")
    t0 = time.monotonic()
    with open(REANALYZE_FILE) as fh:
        text = "".join(fh.readlines()[:2])
    arrays = []
    with tempfile.TemporaryDirectory() as tmp:
        for where in (dev.type, "cpu"):
            path = os.path.join(tmp, f"{where}.npz")
            sys.stdin = io.StringIO(text)
            try:
                tool_run("sgf2array", sgf2array.main,
                         [path, "--device", where])
            finally:
                sys.stdin = sys.__stdin__
            with np.load(path) as z:
                arrays.append({k: z[k] for k in z.files})
    check(sorted(arrays[0]) == sorted(arrays[1]) and len(arrays[0]) == 10
          and all(np.array_equal(arrays[0][k], arrays[1][k])
                  for k in arrays[0]), "sgf2array: card != cpu")
    phase("tools", t0, "sgf2array of two rl20 games: card == cpu")
    return total


# ---------------------------------------------------------------------------
# 5c'. self-play workers and the trainer over shared storage


def distr_phase(dev):
    """``dream_go_torch.distr_env``'s worker and trainer in this process
    over one ``--root`` at 128 x 9, launch counts zeroed before and read
    after each step: a policy-play round on random weights with planes
    30/31 (K2), a trainer generation (K3b and K2 in its bank) whose
    published weights' bf16 eval must match the trainer's float32 net
    within the sanity net's limits, a second round on those weights, a
    resumed trainer generation, and a search-mode round on generation 1
    (K1, K2).  Every game must be well formed and parse."""
    import shutil

    from dream_go_torch.distr_env import dg_storage, run_train, run_worker
    from dream_go_torch.models import params as MP
    from dream_go_torch.models import tower as T
    from dream_go_torch.train.train_loop import Trainer
    from dream_go_torch.utils import sgf

    t_phase = time.monotonic()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DISTR_DIR)
    shutil.rmtree(root, ignore_errors=True)
    common = ["--root", root, "--device", dev.type]
    policy = ["--games", str(DISTR_GAMES), "--rounds", "1", "--max-moves",
              str(DISTR_MOVES)]
    train = ["--batch-size", str(DISTR_BATCH), "--steps-per-gen",
             str(DISTR_STEPS), "--min-new-games", str(DISTR_GAMES),
             "--rounds", "1", "--ladder-features", "--bank-games",
             str(DISTR_BANK), "--positions-per-game", str(DISTR_POSITIONS)]
    steps = [
        ("worker 0", run_worker.main, policy + [
            "--ladder-features", "--worker-id", "smoke0", "--seed", "0"],
         "weights generation -1", ("ladder_planes",)),
        ("trainer 0", run_train.main, train, "trainer: gen 0 ",
         ("ladder_planes", "board_features_raw")),
        ("worker 1", run_worker.main, policy + [
            "--worker-id", "smoke1", "--seed", "1"],
         "weights generation 0", ("ladder_planes",)),
        ("trainer 1", run_train.main, train, "trainer: gen 1 ",
         ("ladder_planes", "board_features_raw")),
        ("worker 2", run_worker.main, [
            "--games", str(DISTR_SEARCH_GAMES), "--rounds", "1",
            "--max-moves", str(DISTR_SEARCH_MOVES), "--num-rollout",
            str(DISTR_ROLLOUTS), "--worker-id", "smoke2"],
         "weights generation 1", ("leaf_step", "ladder_planes")),
    ]
    total = {}
    for name, main, argv, expect, needs in steps:
        out, launches, wall = tool_run(name, main, common + argv)
        text = "\n".join(out)
        check(expect in text, f"distr {name}: no {expect!r} in {out}")
        for k in needs:
            check(launches[k] > 0, f"distr {name} never launched {k}: "
                  f"{launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        phase("distr", time.monotonic() - wall,
              f"{name}: {out[-1]}, {wall:.2f} s, launches {launches}")
        if name == "trainer 0":
            t0 = time.monotonic()
            _, path = dg_storage.latest_weights(root)
            with open(path) as fh:
                cfg, folded = MP.load_json(fh.read())
            check((cfg.num_channels, cfg.num_blocks, cfg.ladder_features)
                  == (128, 9, True), f"the published net is {cfg}")
            served = T.from_state_dict(cfg, MP.to_state_dict(cfg, folded),
                                       dev)
            trainer = Trainer.restore(os.path.join(root,
                                                   run_train.CHECKPOINT),
                                      device=dev)
            learner = T.from_state_dict(
                cfg, MP.fold_train(cfg, trainer.state_dict()), dev,
                "float32")
            planes = torch.from_numpy((np.random.default_rng(1).random(
                (16, 32, 19, 19)) < 0.3).astype(np.float32)).to(dev)
            with torch.no_grad():
                logits, value, _ = served(planes.to(torch.bfloat16))
                logits32, value32, _ = learner(planes)
            gaps = bf16_gaps((value + 1) / 2,
                             torch.softmax(logits.float(), -1),
                             ((value32 + 1) / 2).cpu(),
                             torch.softmax(logits32, -1).cpu())
            limits = (BF16_VALUE_ATOL, BF16_POLICY_ATOL, BF16_POLICY_KL)
            check(all(g <= lim for g, lim in zip(gaps, limits)),
                  f"the published weights' bf16 eval is off the trainer's "
                  f"float32 net by {gaps} (limits {limits})")
            phase("distr", t0, f"weights_000000.json (128x9, planes on) "
                  f"in bf16 vs the trainer's float32 net at step "
                  f"{trainer.step}: max |dv|, |dp|, KL {gaps} (limits "
                  f"{limits})")
    lines = dg_storage.new_games(root, set())[0]
    check(len(lines) == 2 * DISTR_GAMES + DISTR_SEARCH_GAMES,
          f"distr: {len(lines)} games")
    moves = 0
    for line in lines:
        check(sgf.parse_line(line) is not None, f"unparsed: {line[:200]}")
        if "TV[" in line:
            moves += check_sgf(line, DISTR_ROLLOUTS)
        else:
            moves += check_loop_sgf(line, 1)[0]
    phase("distr", t_phase, f"{len(lines)} games ({moves} moves) parse, "
          f"2 generations published, launches {total}")
    return total


# ---------------------------------------------------------------------------
# 5d. the benchmark entry


def bench_phase():
    """``dream_go_torch.bench.main`` in this process, launch counts zeroed
    before and read after; its JSON line must carry every key with a
    finite value, and the env stage must have run on the kernel."""
    import contextlib
    import io
    import math

    from dream_go_torch import bench

    t0 = time.monotonic()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, launches, wall = counted(lambda: bench.main(BENCH_ARGS))
    check(rc == 0, f"bench exited {rc}")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in line]
    check(not missing, f"bench JSON line lacks {missing}: {line}")
    for k in BENCH_KEYS:
        if k not in ("metric", "unit", "selfplay_rate_mode"):
            check(isinstance(line[k], (int, float)) and math.isfinite(line[k])
                  and line[k] > 0, f"bench {k} = {line[k]!r}")
    check(launches["env_step"] >= 151 and launches["leaf_step"] > 0,
          f"bench launches {launches}")
    log(f"  bench JSON ({' '.join(BENCH_ARGS)}): {json.dumps(line)}")
    phase("bench", t0, f"wall {wall:.1f} s, launches {launches}")
    return line, launches


# ---------------------------------------------------------------------------
# 6. the sanity net


def bf16_gaps(v, p, v32, p32):
    """Max |value| and |policy| differences and KL(fp32 || bf16) of the
    policy, the card's outputs against the CPU's float32."""
    v, p = v.float().cpu(), p.float().cpu()
    kl = (p32 * (p32.log() - p.clamp(min=1e-30).log())).sum(-1)
    return (float((v - v32).abs().max()), float((p - p32).abs().max()),
            float(kl.max()))


def sanity_phase(dev):
    """The committed 64 x 6 net whose contract includes planes 30/31,
    through the CLI's loader: root evals of the ladder positions, bf16 on
    the card against float32 on the CPU.  The same eval with planes 30/31
    zeroed must fail the limits, so that they can tell a wrong input."""
    from dream_go_torch import cli
    from dream_go_torch.go import features

    t0 = time.monotonic()
    argv = ["--self-play", "1", "--continuous", "--num-rollout", "2",
            "--weights", "tests/fixtures/sanity_net.json"]
    args = cli.build_parser().parse_args(argv)
    check(args.ladder_features is None, "--ladder-features preset")
    card = cli.load_predictor(args, dev)
    check(args.ladder_features is True,
          "the sanity net's contract did not turn planes 30/31 on")
    cpu_args = cli.build_parser().parse_args(argv)
    host = cli.load_predictor(cpu_args, torch.device("cpu"))
    check(next(card.model.parameters()).dtype == torch.bfloat16,
          "the card's tower is not bf16")
    x = features.extract_batch(ladder_positions(dev), True, False, True)
    x_cpu = features.extract_batch(ladder_positions("cpu"), True, False,
                                   True)
    check(torch.equal(x.cpu(), x_cpu), "card and CPU planes differ")
    check(float(x[..., 30].sum() + x[..., 31].sum()) > 0,
          "no ladder plane set in the sanity positions")
    limits = (BF16_VALUE_ATOL, BF16_POLICY_ATOL, BF16_POLICY_KL)
    v, p = card(x)
    v32, p32 = host(x_cpu)
    check(torch.isfinite(v).all() and torch.isfinite(p).all(),
          "non-finite sanity-net outputs")
    gaps = bf16_gaps(v, p, v32, p32)
    check(all(g <= lim for g, lim in zip(gaps, limits)),
          f"bf16 eval off float32 by {gaps} (limits {limits})")
    wrong = x.clone()
    wrong[..., 30:32] = 0
    wrong_gaps = bf16_gaps(*card(wrong), v32, p32)
    check(any(g > lim for g, lim in zip(wrong_gaps, limits)),
          f"the limits {limits} pass an eval without planes 30/31 "
          f"({wrong_gaps})")
    # the card's top move may differ from float32's only in a near-tie:
    # its fp32 probability within the policy limit of the top one
    top = p.float().cpu().argmax(-1)
    margin = p32.max(-1).values - p32.gather(1, top[:, None])[:, 0]
    check(float(margin.max()) <= BF16_POLICY_ATOL,
          f"the card's top moves {top.tolist()} trail float32's "
          f"{p32.argmax(-1).tolist()} by {margin.tolist()}")
    phase("sanity net", t0,
          f"planes 30/31 on from the contract; ladder points "
          f"{int(x[..., 30].sum())} capture, {int(x[..., 31].sum())} "
          f"escape; bf16 vs fp32 max |dv|, |dp|, KL {gaps} (limits "
          f"{limits}); planes 30/31 zeroed {wrong_gaps}, rejected; argmax "
          f"{top.tolist()} vs {p32.argmax(-1).tolist()}, fp32 margin "
          f"{[f'{m:.2e}' for m in margin.tolist()]}")


# ---------------------------------------------------------------------------
# 7. timing


def leaf_step_bound(states, actions) -> tuple[float, str]:
    """Least time for one leaf_step launch on these inputs: bytes (each
    input read once, each output written once) over HBM rate, or its
    integer operations over the scalar issue rate, the larger."""
    from dream_go_torch.go import engine

    b = states.batch
    per_in = 4 * (384 + 384 + 2 * 384 + 2 * 128 + 8 + 8 + 1 + 1)
    per_out = 4 * (384 + 384 + 2 * 384 + 2 * 128 + 8 + 8 + 32 * 384) + 361
    nbytes = b * (per_in + per_out) + 4 * 4 * 384  # + the zobrist table
    # operations the data needs: ~200 per point for the move, liberties
    # and planes; 12 words x ~10 ops per pseudo-legal point and colour for
    # the liberties after a move; 3 per valid ring entry per candidate
    new = engine.step(states, actions)
    pseudo = sum(int(engine.pseudo_legal_mask(new, c).sum()) for c in (1, 2))
    ring = torch.clamp(new.placed_count, max=64).float()
    cand = engine.pseudo_legal_mask(new).sum(1).float()
    ops = b * 384 * 200 + pseudo * 120 + float((cand * ring * 3).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ladder_bound(sub, rungs: int) -> tuple[float, str]:
    """Least time for one ladder_planes launch: bytes (stones and cid rows
    and to_move in, two bool planes out) over HBM rate, or the operations
    of the rungs the reading needs on these boards (the plain version
    counts them, an escape's counter-attacks up to the first that
    captures) and the candidate scan, over the scalar issue rate."""
    b = sub.batch
    nbytes = b * (2 * 4 * 384 + 4 + 2 * 361)
    ops = rungs * LADDER_OPS_PER_RUNG + b * 361 * LADDER_OPS_PER_POINT
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_chain(stats) -> int:
    """The most rungs one warp of the ladder kernel walks in a row: each
    board's chases, in the order the plain version lists them, taken one
    at a time by whichever of its LADDER_WARPS warps is free first (a rung
    the unit of time), as the kernel's shared-memory counter deals them."""
    free, longest = {}, 0
    for board, rungs in zip(stats["job_board"].tolist(),
                            stats["job_rungs"].tolist()):
        warps = free.setdefault(board, [0] * LADDER_WARPS)
        done = heapq.heappop(warps) + rungs
        heapq.heappush(warps, done)
        longest = max(longest, done)
    return longest


def ladder_rung_ms(dev) -> tuple[float, int]:
    """The kernel's time per rung of one serial chase: one staircase board
    against one empty board, both B=1 graph replays, over the staircase's
    longest warp chain.  Returns ``(ms per rung, rungs)``."""
    from dream_go_torch.go import boards
    from dream_go_torch.ops import ladder_kernel as LK

    stair = ladder_args(boards.from_stones(boards.ladder_stress()[:1], dev))
    empty = ladder_args(boards.from_stones([[0] * 361], dev))
    stats = {}
    LK.ladder_planes_plain(*stair, stats=stats)
    chain = warp_chain(stats)
    t_stair = graph_ms(lambda: LK.ladder_planes_kernel(*stair))
    t_empty = graph_ms(lambda: LK.ladder_planes_kernel(*empty))
    return (t_stair - t_empty) / chain, chain


def libs_after_bound(sub) -> tuple[float, str]:
    """Least time for one board_features_raw launch: bytes (stones and cid
    rows in, five i32 rows out) over HBM rate, or its operations (per
    point ~20 for the liberties and bit sets, and per point and colour 12
    words x ~8 for the counting identity) over the scalar issue rate."""
    b = sub.batch
    nbytes = b * (2 * 4 * 384 + 5 * 4 * 361)
    ops = b * 361 * (20 + 2 * 12 * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def env_step_bound(sub, with_bits: bool = False) -> tuple[float, str]:
    """Least time for one env_step launch on these boards: bytes (each
    board's six rows read and written, its weights, and its words when
    given, read, its move written; the zobrist table once) over HBM rate,
    or its operations (~100 a point for the neighbours, liberties,
    candidate hash, random word, Gumbel score, argmax and the move; 3 per
    valid ring entry per pseudo-legal point) over the scalar issue rate."""
    from dream_go_torch.go import engine

    b = sub.batch
    rows = 4 * (384 + 384 + 2 * 384 + 2 * 128 + 8 + 8)
    nbytes = b * (2 * rows + 4 * 361 * (2 if with_bits else 1) + 4) \
        + 4 * 4 * 384
    ring = torch.clamp(sub.placed_count, max=64).float()
    pseudo = engine.pseudo_legal_mask(sub).sum(1).float()
    ops = b * 384 * 100 + float((pseudo * ring * 3).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leaf_step_timing(states, actions, sel):
    """K1 on the boards ``sel`` (the main path's batch) and on all of
    ``states`` (the bench's MCTS batch, LEAF_BENCH_BATCH); returns the
    first row and logs both."""
    from dream_go_torch.ops import layout
    from dream_go_torch.ops import leaf_step as L

    check(states.batch == LEAF_BENCH_BATCH, "leaf_step timing boards")
    res = {}
    for idx in (sel, torch.arange(states.batch, device=sel.device)):
        sub = states.index(idx)
        args = [t.contiguous() for t in layout.pack_states(sub)]
        act, komi = actions[idx].contiguous(), sub.komi.contiguous()
        leaf = lambda: L.leaf_step(*args, act, komi)
        v = res[sub.batch] = dict(
            ms=graph_ms(leaf), eager_ms=events_ms(leaf, 50),
            plain_ms=events_ms(lambda: L.leaf_step_plain(*args, act, komi),
                               10),
            bound=leaf_step_bound(sub, act))
        log(f"  leaf_step B={sub.batch}: kernel {v['ms'] * 1e3:.2f} us "
            f"(eager call {v['eager_ms'] * 1e3:.2f} us), bound "
            f"{v['bound'][0] * 1e3:.2f} us ({v['bound'][1]}), plain "
            f"{v['plain_ms'] * 1e3:.1f} us")
    return res[len(sel)]


def libs_after_timing(states, sel):
    """K3 on the boards ``sel`` (the main path's batch) and on all of
    ``states`` (the bench's ``--full`` feature batch,
    FEATURE_BENCH_BATCH); returns the first row and logs both."""
    from dream_go_torch.ops import layout
    from dream_go_torch.ops import libs_after as LA

    check(states.batch == FEATURE_BENCH_BATCH, "libs_after timing boards")
    res = {}
    for idx in (sel, torch.arange(states.batch, device=sel.device)):
        sub = states.index(idx)
        st, cid = (t.contiguous() for t in layout.pack_states(sub)[:2])
        feats = lambda: LA.features_raw(st, cid)
        v = res[sub.batch] = dict(
            ms=graph_ms(feats), eager_ms=events_ms(feats, 50),
            plain_ms=events_ms(lambda: LA.features_raw_plain(st, cid), 10),
            bound=libs_after_bound(sub))
        log(f"  board_features_raw B={sub.batch}: kernel "
            f"{v['ms'] * 1e3:.2f} us (eager call {v['eager_ms'] * 1e3:.2f} "
            f"us), bound {v['bound'][0] * 1e3:.2f} us ({v['bound'][1]}), "
            f"plain {v['plain_ms'] * 1e3:.1f} us")
    return res[len(sel)]


def env_step_timing(env_states):
    """K4 in the bench's mode (uniform weights, Philox words) at B=256 and
    at the bench's B=4096; returns the B=4096 row and logs both."""
    from dream_go_torch.ops import env_step as E
    from dream_go_torch.ops import layout

    rows_all = [t.contiguous() for t in layout.pack_states(env_states)]
    res = {}
    for b in (TIMING_BATCH, max(ENV_BATCHES)):
        rows = [t[:b].contiguous() for t in rows_all]
        w = torch.ones(b, 361, device=rows[0].device)
        step = lambda: E.env_step(*rows, w, 7)
        res[b] = dict(
            ms=graph_ms(step), eager_ms=events_ms(step, 50),
            plain_ms=events_ms(lambda: E.env_step_plain(*rows, w, 7), 5),
            bound=env_step_bound(env_states.index(
                torch.arange(b, device=rows[0].device))))
        v = res[b]
        log(f"  env_step B={b}: kernel {v['ms'] * 1e3:.2f} us (eager call "
            f"{v['eager_ms'] * 1e3:.2f} us), bound "
            f"{v['bound'][0] * 1e3:.2f} us ({v['bound'][1]}), plain "
            f"{v['plain_ms'] * 1e3:.1f} us")
    return res[max(ENV_BATCHES)]


def select_walk_bound(t, path_n) -> tuple[float, str]:
    """Least time for one select-walk launch on these trees: the bytes the
    walks read (the root's full-width arrays, prior row, bitset and
    statistics; at each non-root level the node's statistics, its K slots,
    prior row and bitset) and write, over HBM rate."""
    from dream_go_torch.ops import select_walk as SW

    b, _, k = t.slot_action.shape
    root = SW.A * (4 + 4 + 4 + 2) + SW.NCW * 4 + 8
    level = 8 + k * 16 + SW.A * 2 + SW.NCW * 4
    levels = int((path_n[:, 1:] >= 0).sum())
    nbytes = b * root + levels * level + b * (16 + 8 * path_n.shape[1])
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def select_walk_timing(dev):
    """The select walk on the grown trees at B = 256 and 1024 (the main
    path's capacity): kernel (graph replays and eager calls), plain walk
    and bound; returns the B = 1024 row and logs both."""
    from dream_go_torch.ops import select_walk as SW

    res = {}
    for b in (TIMING_BATCH, LEAF_BENCH_BATCH):
        t, cfg = walk_trees(dev, b)
        args = (t, cfg.uct_exp, cfg.fpu_reduce, b, t.node_n.shape[1])
        walk = lambda: SW.select_walk(*args)
        path_n = walk()[3]
        lv = (path_n[:, 1:] >= 0).sum(1)
        v = res[b] = dict(
            ms=graph_ms(walk), eager_ms=events_ms(walk, 50),
            plain_ms=events_ms(lambda: SW.select_walk_plain(*args), 3),
            bound=select_walk_bound(t, path_n))
        log(f"  select_walk B={b} (levels {float(lv.float().mean()):.2f} "
            f"mean, {int(lv.max())} max): kernel {v['ms'] * 1e3:.2f} us "
            f"(eager call {v['eager_ms'] * 1e3:.2f} us), bound "
            f"{v['bound'][0] * 1e3:.2f} us ({v['bound'][1]}), plain "
            f"{v['plain_ms'] * 1e3:.1f} us")
    return res[LEAF_BENCH_BATCH]


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=50):
    """Card time per launch of ``fn`` captured ``reps`` times in a CUDA
    graph and replayed (the host-side wrapper cost excluded)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return events_ms(graph.replay, 5) / reps


def timing_phase(states, actions, env_states):
    from dream_go_torch.ops import ladder_kernel as LK

    t0 = time.monotonic()
    b = TIMING_BATCH
    sel = torch.arange(b, device=states.stones.device) * (states.batch // b)
    sub = states.index(sel)
    out = {}

    out["leaf_step"] = leaf_step_timing(states, actions, sel)

    largs = ladder_args(sub)
    stats = {}
    LK.ladder_planes_plain(*largs, stats=stats)
    rungs = int(stats["job_rungs"].sum())
    ladder = lambda: LK.ladder_planes_kernel(*largs)
    out["ladder_planes"] = dict(
        ms=graph_ms(ladder), eager_ms=events_ms(ladder, 50),
        plain_ms=events_ms(lambda: LK.ladder_planes_plain(*largs), 3),
        bound=ladder_bound(sub, rungs))
    rung_ms, stair_chain = ladder_rung_ms(states.stones.device)
    longest, chain = stats["longest_chase"], warp_chain(stats)

    out["board_features_raw"] = libs_after_timing(states, sel)
    out["env_step"] = env_step_timing(env_states)
    out["select_walk"] = select_walk_timing(states.stones.device)
    log(f"  ladder_planes serial chain: {rung_ms * 1e3:.3f} us a rung "
        f"(staircase, {stair_chain} rungs, B=1); at B={b} the longest chase "
        f"is {longest} rungs ({longest * rung_ms * 1e3:.2f} us) and the "
        f"longest warp chain {chain} rungs ({chain * rung_ms * 1e3:.2f} us) "
        f"of {rungs} rungs in all")
    phase("timing", t0, f"B={b} (env_step B={max(ENV_BATCHES)}; leaf_step "
          f"B={LEAF_BENCH_BATCH}, board_features_raw "
          f"B={FEATURE_BENCH_BATCH} and select_walk B={LEAF_BENCH_BATCH} "
          f"above): " + "; ".join(
        f"{k} kernel {v['ms'] * 1e3:.2f} us (eager call "
        f"{v['eager_ms'] * 1e3:.2f} us), bound {v['bound'][0] * 1e3:.2f} us "
        f"({v['bound'][1]}), plain {v['plain_ms'] * 1e3:.1f} us"
        for k, v in out.items()))
    return out


SOURCES = {
    "leaf_step": ("dream_go_torch/csrc/leaf_step.cu",
                  "dream_go_tpu/ops/leaf_step.py:383"),
    "ladder_planes": ("dream_go_torch/csrc/ladder_planes.cu",
                      "dream_go_tpu/ops/ladder_kernel.py:518"),
    "board_features_raw": ("dream_go_torch/csrc/libs_after.cu",
                           "dream_go_tpu/ops/libs_after.py:176"),
    "env_step": ("dream_go_torch/csrc/env_step.cu",
                 "dream_go_tpu/ops/env_step.py:355"),
    # no Pallas kernel: the JAX package's walk is a jax.lax.while_loop
    "select_walk": ("dream_go_torch/csrc/select_walk.cu",
                    "dream_go_tpu/mcts/search.py:430"),
}


def main() -> int:
    smi = device_phase()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_phase()
    errs, states, actions, env_states = parity_phase(dev)
    # the CPU sides of the card-against-CPU checks run in this process
    # meanwhile (spawned: a forked child must not inherit CUDA)
    with concurrent.futures.ProcessPoolExecutor(
            HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=torch.set_num_threads,
            initargs=(HOST_THREADS,)) as host:
        # the dry run's rank, host-bound, beside a phase that times nothing
        with concurrent.futures.ThreadPoolExecutor(1) as beside:
            dryrun = beside.submit(dryrun_check, dev)
            reference_phase(dev, host)
            dryrun.result()
        launches = selfplay_phase(dev)
        serve_phase(dev, host)
        train_phase(dev, host)
    loop_phase(dev)
    distill_phase(dev)
    mesh_launches = mesh_phase(dev)
    tools_launches = tools_phase(dev)
    distr_launches = distr_phase(dev)
    _, bench_launches = bench_phase()
    launches["env_step"] = bench_launches["env_step"]
    for more in (mesh_launches, tools_launches, distr_launches):
        for k in launches:
            launches[k] += more.get(k, 0)
    sanity_phase(dev)
    times = timing_phase(states, actions, env_states)
    log(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": SOURCES[name][0],
        "replaces": SOURCES[name][1], "launches": launches[name],
        "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
        "library_ms": None} for name, t in times.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
