"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each printed with its seconds:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   matmul and cuDNN;
2. build: every CUDA kernel of the port, one nvcc per source, started
   together;
3. parity: each kernel against its plain PyTorch version on the card,
   bit for bit, on boards from the port's engine (random legal play stopped
   between 0 and 250 moves, passes, finished games, a super-ko in the
   ring), at the batch sizes the search uses;
4. reference: a small self-play run on the card (kernel) and on the CPU
   (plain version) with a deterministic predictor gives the same games;
5. self-play: the main path, ``python -m dream_go_torch.cli --self-play 256
   --continuous --num-rollout 64 --num-games 256 --max-moves 16`` through
   the CLI's code, at the full 128 x 9 width with seeded random weights,
   with the kernels' launch counts read just before and just after;
6. timing: each kernel at the main path's batch beside its memory bound and
   its plain version.

The second-to-last line is one JSON object with a row per kernel, the line
before it the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises, and the script
exits non-zero without that last line, as it does where there is no CUDA
device or no checkout of the repository around it.
"""

from __future__ import annotations

import base64
import concurrent.futures
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: the main path's shapes
GAMES, ROLLOUTS, MAX_MOVES = 256, 64, 16
PARITY_BATCHES = (1, 7, 256, 1024)
TIMING_BATCH = 256
#: H100 SXM HBM rate and the non-tensor-core fp32/int32 issue rate
#: (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

P = lambda x, y: 19 * y + x
#: black captures a white stone at (1,1) by playing (2,1); white's
#: recapture is then a super-ko
KO_MOVES = [P(1, 0), P(2, 0), P(0, 1), P(3, 1), P(1, 2), P(2, 2), P(10, 10),
            P(1, 1)]
KO_ACTION = P(2, 1)


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
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(build.build, names)))
    for name in names:
        build.load(name)
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    phase("build", t0, ", ".join(f"{n} -> {p.name}" for n, p in
                                 paths.items()))


# ---------------------------------------------------------------------------
# 3. kernel parity


def random_boards(n: int, dev, seed: int = 0):
    """Port-engine boards on the card: random legal play stopped at move
    counts spread over 0..250 (2% passes), every 16th board a scripted ko,
    every 16th (offset 5) board finished by two passes.  Returns
    ``(states, actions)`` with actions chosen for the kind of board."""
    from dream_go_torch.go import engine

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


def parity_phase(dev):
    from dream_go_torch.ops import layout
    from dream_go_torch.ops import leaf_step as L

    t0 = time.monotonic()
    states, actions = random_boards(max(PARITY_BATCHES), dev, seed=1)
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
        want = L.leaf_step_plain(*args, act, komi)
        torch.cuda.synchronize()
        outs = list(zip(got[0], want[0])) + [(got[1], want[1]),
                                             (got[2], want[2])]
        for g, w in outs:
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:10].tolist()
                raise RuntimeError(f"leaf_step differs at B={b}: {bad}")
            worst = max(worst, float((g.double() - w.double()).abs().max()))
        if bool(((sel % 16) == 3).any()):  # a ko board: plane 29 is set
            check(float(got[1][:, 29].sum()) > 0, "no super-ko plane set")
    phase("parity", t0, f"leaf_step bit-exact vs plain at B="
          f"{list(PARITY_BATCHES)} (max abs err {worst})")
    return worst, states, actions


# ---------------------------------------------------------------------------
# 4. reference: kernel path on the card == plain path on the CPU


def det_predictor():
    """A deterministic predictor whose policy and value are dyadic numbers
    (float32 sums of them are exact in any order), so the search decisions
    do not depend on where it runs."""
    from dream_go_torch.mcts.predictor import Predictor

    w = torch.from_numpy(
        (np.arange(19 * 19 * 32).reshape(19, 19, 32) % 7 + 1).astype(np.int32))

    def predict(feats):
        bits = (feats > 0.5).to(torch.int32)
        h = (bits * w.to(feats.device)).sum(dim=(1, 2, 3))
        a = torch.arange(362, dtype=torch.int32, device=feats.device)
        k = (h[:, None] * 31 + a[None, :] * 17) % 251 + 1
        return ((h % 200) + 28).float() / 256.0, k.float() / 4096.0

    return Predictor(predict)


def reference_phase(dev):
    from dream_go_torch.config import SearchConfig, SelfPlayConfig
    from dream_go_torch.selfplay.search_play import \
        search_self_play_continuous

    t0 = time.monotonic()
    cfg = SelfPlayConfig(num_games=4, num_rollout=16, max_moves=12,
                         temperature_moves=0)
    scfg = SearchConfig(num_rollout=16, dirichlet_noise=0.0, fused=True,
                        adaptive=True)
    runs = [search_self_play_continuous(det_predictor(), cfg, scfg, seed=0,
                                        batch=4, device=d)
            for d in (dev, "cpu")]
    strip = [[re.sub(r"DT\[[^\]]*\]", "", g) for g in r] for r in runs]
    check(len(strip[0]) == 4 and strip[0] == strip[1],
          "self-play on the card differs from the CPU reference")
    phase("reference", t0, "4 games x 16 rollouts: card (kernel) == cpu "
          "(plain), move for move")


# ---------------------------------------------------------------------------
# 5. the main path

SGF_RE = re.compile(
    r"^\(;GM\[1\]FF\[4\]DT\[[^\]]*\]SZ\[19\]RU\[Chinese\]KM\[-?\d+\.\d\]"
    r"RE\[(?:[BW]\+\d+\.\d|0)\]"
    r"((?:;[BW]\[(?:[a-s]{2})?\]TV\[\d+\]P\[[^\]]+\]V\[-?\d\.\d{4}\])+)"
    r"(?:TB(?:\[[a-s]{2}\])+)?(?:TW(?:\[[a-s]{2}\])+)?\)$")
MOVE_RE = re.compile(r";([BW])\[([a-s]{2})?\]TV\[(\d+)\]P\[([^\]]+)\]"
                     r"V\[(-?\d\.\d{4})\]")


def check_sgf(line: str) -> int:
    """Raise unless ``line`` is a well-formed self-play record; returns its
    number of moves."""
    m = SGF_RE.match(line)
    check(m, f"malformed SGF line: {line[:200]}")
    moves = MOVE_RE.findall(m.group(1))
    for i, (color, _, tv, blob, value) in enumerate(moves):
        policy = np.frombuffer(base64.b85decode(blob), np.float16)
        check(color == "BW"[i % 2] and 1 < int(tv) <= ROLLOUTS
              and policy.shape == (362,) and np.isfinite(policy).all()
              and abs(float(policy.astype(np.float32).sum()) - 1.0) < 0.02
              and -1.0 <= float(value) <= 1.0,
              f"bad move {i} in SGF line: {line[:200]}")
    return len(moves)


def selfplay_phase():
    from dream_go_torch import cli
    from dream_go_torch.ops import leaf_step as L

    args = cli.build_parser().parse_args([
        "--self-play", str(GAMES), "--continuous", "--num-rollout",
        str(ROLLOUTS), "--num-games", str(GAMES), "--max-moves",
        str(MAX_MOVES), "--seed", "0"])
    check((args.num_channels, args.num_blocks) == (128, 9),
          "the main path runs at 128 x 9")
    stats = {}
    torch.cuda.synchronize()
    L.launches = 0
    t0 = time.monotonic()
    games = cli.self_play(args, stats=stats)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"leaf_step": L.launches}
    check(len(games) == GAMES, f"{len(games)} games instead of {GAMES}")
    moves = sum(check_sgf(g) for g in games)
    events = stats["move_events"]
    sims = sum(e[2] for e in events)
    check(launches["leaf_step"] > 0, "the main path never launched leaf_step")
    phase("selfplay", t0,
          f"128x9 net, {GAMES} games, {len(events)} batch moves, "
          f"{moves} game moves, leaf_step launches {launches['leaf_step']} "
          f"({launches['leaf_step'] / len(events):.1f} per batch move); "
          f"games/s {GAMES / wall:.3f} moves/s {moves / wall:.1f} "
          f"sims/s {sims / wall:.1f}")
    return launches


# ---------------------------------------------------------------------------
# 6. timing


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


def timing_phase(states, actions):
    from dream_go_torch.ops import layout
    from dream_go_torch.ops import leaf_step as L

    t0 = time.monotonic()
    b = TIMING_BATCH
    sel = torch.arange(b, device=states.stones.device) * (states.batch // b)
    sub = states.index(sel)
    args = [t.contiguous() for t in layout.pack_states(sub)]
    act, komi = actions[sel].contiguous(), sub.komi.contiguous()

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

    # the kernel alone: launches captured in a CUDA graph run back to back
    # (host-side wrapper cost excluded); eager calls for comparison
    L.leaf_step(*args, act, komi)
    torch.cuda.synchronize()
    reps = 50
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            L.leaf_step(*args, act, komi)
    kernel_ms = events_ms(graph.replay, 5) / reps
    eager_ms = events_ms(lambda: L.leaf_step(*args, act, komi), 50)
    plain_ms = events_ms(lambda: L.leaf_step_plain(*args, act, komi), 10)
    bound_ms, bound_by = leaf_step_bound(sub, act)
    phase("timing", t0, f"leaf_step B={b}: kernel {kernel_ms * 1e3:.2f} us "
          f"(eager call {eager_ms * 1e3:.2f} us), bound {bound_ms * 1e3:.2f} "
          f"us ({bound_by}), plain {plain_ms * 1e3:.1f} us")
    return kernel_ms, plain_ms, bound_ms, bound_by


def main() -> int:
    smi = device_phase()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_phase()
    max_err, states, actions = parity_phase(dev)
    reference_phase(dev)
    launches = selfplay_phase()
    kernel_ms, plain_ms, bound_ms, bound_by = timing_phase(states, actions)
    log(json.dumps({"kernels": [{
        "name": "leaf_step", "route": "cuda",
        "source": "dream_go_torch/csrc/leaf_step.cu",
        "replaces": "dream_go_tpu/ops/leaf_step.py:383",
        "launches": launches["leaf_step"], "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
