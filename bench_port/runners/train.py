"""The trainer at its default batch, fed from an example bank.

Drives ``train.train_loop.Trainer.fit`` with an ``ExampleSource`` built
from the mix's recorded games (``bank_games`` games x
``positions_per_game`` positions, drawn by the seed), bf16 autocast, Adam,
the decoupled L2 and the max-norm projection.  The source handed to
``fit`` stamps each batch request and stops yielding once the window's
time is up; ``fit`` copies each step's metrics to the host before it asks
for the next batch, so the gap between two stamps is one whole step.

One ``fit`` call, on one trainer with the benchmark's weights, is both
set-up and window: its first ``checked_steps`` steps build the bank, warm
every shape and are kept for the check; the window opens at the next
batch request and the same call runs on.  The check follows those steps
with the float32 reference of ``reference/tower.py`` on the same batches
and weights, and holds the program to the numbers its traffic mix gives
a limit:

- ``grad_gap_median``: the first step's gradient as Adam received it (its
  first moment over 1 - beta1): per leaf, the gap of its norm from the
  reference's, over the larger of that leaf's reference norm and the
  median leaf's; the median over the leaves;
- ``delta_gap_median``: the same for each leaf's change over the checked
  steps;
- ``batch_diff``: sampled rows of the checked batches that are not a
  symmetric copy of the reference's planes and labels (replayed and read
  from the recorded game with ``reference/go.py`` and
  ``reference/sgf.py``) of a position the bank holds, under one symmetry
  for planes, policy and ownership alike.  The reference's steps take the
  program's batches; this check holds those batches to the games.

The worst leaf's gaps (``grad_gap``, ``delta_gap``), each step's loss
(``loss_gap``) and the first step's (``loss1_gap``) are reported beside
them, not compared: the worst leaves are the residual gates and
batch-norm offsets, whose first gradient sums some 10^8 bf16 products
that nearly cancel, and the losses' gaps swing from seed to seed as
widely as the float8 control's.  Leaves whose reference gradient is under
a thousandth of the median leaf's are left out: Adam moves them by
round-off alone.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from .. import counts, games, weights
from ..harness import checks
from ..profiling import Patches, Window, annotated, sync
from ..reference import go as ref_go
from ..reference import sgf as ref_sgf
from ..reference import tower as ref_tower


class StampedSource:
    """An example source that stamps each batch request once the window
    is open and stops at ``deadline``.  The first ``open_after`` batches
    are set-up's: they are kept on the host for the check, and the request
    after them calls ``on_open``, which opens the window."""

    def __init__(self, inner, open_after: int):
        self.inner = inner
        self.batch_size = inner.batch_size
        self.open_after = open_after
        self.deadline = math.inf
        self.requests = 0
        self.stamps = []
        self.end = None
        self.kept = []
        self.on_open = None
        self.on_request = None

    def batches(self, num_batches: int, rows=None):
        it = iter(self.inner.batches(num_batches))
        for _ in range(num_batches):
            if self.requests == self.open_after and self.on_open is not None:
                self.on_open()
            t = time.perf_counter()
            if self.on_request is not None:
                self.on_request(t)
            if t >= self.deadline:
                self.end = t
                return
            if self.requests >= self.open_after:
                self.stamps.append(t)
            self.requests += 1
            with torch.profiler.record_function("next batch"):
                feats, labels = next(it)
            if len(self.kept) < self.open_after:
                self.kept.append((feats.detach().cpu(),
                                  {k: v.detach().cpu()
                                   for k, v in labels.items()}))
            yield feats, labels


@dataclasses.dataclass
class State:
    trainer: object
    feed: StampedSource
    source: object
    params0: dict
    bank_games: list
    params3: dict = None
    grad1: dict = None
    losses: list = dataclasses.field(default_factory=list)
    batches: list = None
    batch_rows: list = None


def model_configs(cfg: dict):
    from dream_go_torch.config import ModelConfig, TrainConfig

    t = cfg["train"]
    model = ModelConfig(num_channels=cfg["num_channels"],
                        num_blocks=cfg["num_blocks"],
                        num_samples=cfg["num_samples"],
                        num_features=cfg["num_features"],
                        ladder_features=cfg["ladder_features"],
                        compute_dtype=cfg["compute_dtype"])
    train = TrainConfig(batch_size=t["batch_size"],
                        initial_lr=t["initial_lr"], l2_coef=t["l2_coef"],
                        max_norm=t["max_norm"], policy_coef=t["policy_coef"],
                        value_coef=t["value_coef"],
                        ownership_coef=t["ownership_coef"],
                        label_smoothing=t["label_smoothing"])
    return model, train


def make_trainer(cfg: dict, seed: int, device):
    """The program's trainer, holding the benchmark's weights."""
    from dream_go_torch.train.train_loop import Trainer

    model_cfg, train_cfg = model_configs(cfg)
    trainer = Trainer.create(model_cfg, train_cfg, seed=0, device=device)
    w = weights.make(weights.dg_shapes(cfg, train=True), seed, device)
    missing, unexpected = trainer.model.load_state_dict(w, strict=False)
    if unexpected or any(not k.endswith((".mean", ".var")) for k in missing):
        raise RuntimeError(f"weights do not fit the trainer: missing "
                           f"{missing}, unexpected {unexpected}")
    trainer.ema = {k: p.detach().float().clone()
                   for k, p in trainer.model.named_parameters()}
    return trainer, w


def checked_step(state: State, steps: int, real):
    """The program's step, keeping what the check needs of the first
    ``steps``: each loss, the first step's gradients as Adam holds them
    (its first moment over 1 - beta1) and the parameters after the last.
    Those steps are set-up's, so the copies may wait for the device."""

    def step(model, optimizer, cfg, feats, labels, lr, mesh=None):
        out = real(model, optimizer, cfg, feats, labels, lr, mesh)
        k = len(state.losses) + 1
        if k > steps:
            return out
        state.losses.append(float(out["loss"]))
        if k == 1:
            b1 = optimizer.defaults["betas"][0]
            state.grad1 = {n: (optimizer.state[p]["exp_avg"] / (1.0 - b1))
                           .cpu() for n, p in model.named_parameters()}
        if k == steps:
            state.params3 = {n: p.detach().cpu().clone()
                             for n, p in model.named_parameters()}
        return out

    return step


def setup(ctx) -> State:
    from dream_go_torch.train.pipeline import ExampleSource

    tr = ctx.traffic
    source = ExampleSource(games.lines(tr["games"]), tr["batch_size"],
                           seed=ctx.seed, history_len=tr["history_len"],
                           positions_per_game=tr["positions_per_game"],
                           bank_games=tr["bank_games"], device=ctx.device)
    trainer, w = make_trainer(ctx.config, ctx.seed, ctx.device)
    state = State(trainer, StampedSource(source, tr["checked_steps"]),
                  source, {k: v.cpu() for k, v in w.items()}, [])
    # the bank's games as the program drew them: their moves and the
    # positions taken from each, for the check
    draw = source._sample_arrays

    def sample_arrays(g):
        out = draw(g)
        state.bank_games.append((np.asarray(out[0]).copy(),
                                 np.asarray(out[1]).copy()))
        return out

    source._sample_arrays = sample_arrays
    return state


def timed_window(state: State, ctx, prof=None, patches=()) -> dict:
    """One ``fit`` call on the stamped feed: its first ``checked_steps``
    steps finish set-up, the window opens at the next batch request and
    runs until its time is up.  The record of the window's steps (and,
    with ``prof``, the profiler's over its last ``trace_seconds``)."""
    from dream_go_torch.train import train_loop as TL

    feed = state.feed
    opened = {}
    start_at = [math.inf]

    def on_open():
        sync()
        t0 = time.perf_counter()
        opened["t0"] = t0
        feed.deadline = t0 + ctx.seconds
        if ctx.trace:
            start_at[0] = feed.deadline - min(ctx.seconds,
                                              ctx.traffic["trace_seconds"])

    def on_request(t):
        if prof is not None and prof.t0 is None and t >= start_at[0]:
            prof.start()

    feed.on_open, feed.on_request = on_open, on_request
    with Patches() as p:
        for mod, attr, value in patches:
            p.set(mod, attr, value)
        p.set(TL, "train_step", checked_step(
            state, ctx.traffic["checked_steps"], TL.train_step))
        if prof is not None:
            p.set(TL, "train_step", annotated("train step", TL.train_step))
            p.set(state.trainer, "_ema_update",
                  annotated("ema", state.trainer._ema_update))
        state.trainer.fit(feed, 10**9, log_every=0)
        sync()
        t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
    feed.on_open = feed.on_request = None
    state.batches = feed.kept
    t0 = opened["t0"]
    stamps = feed.stamps + [feed.end if feed.end is not None else t1]
    steps = len(feed.stamps)
    record = {"trace": ctx.trace, "opened_at": t0, "window_s": t1 - t0,
              "steps": steps, "batch": feed.batch_size,
              "step_s": list(np.diff(stamps)),
              "to_last_step_s": stamps[-1] - t0,
              "attempted": steps, "failed": 0}
    if prof is not None:
        record["profile"] = prof.summary()
    return record


def window(state: State, ctx) -> dict:
    record = timed_window(state, ctx, Window() if ctx.trace else None)
    record["flops_per_position"] = counts.dg_config_flops(ctx.config)
    return record


# ---------------------------------------------------------------------------
# the check


def _d8() -> np.ndarray:
    """The board's eight symmetries as gathers: ``out[i] = in[T[i]]``."""
    y0, x0 = np.divmod(np.arange(ref_go.NN), ref_go.N)
    out = []
    for turns in range(4):
        y, x = y0, x0
        for _ in range(turns):
            y, x = x, ref_go.N - 1 - y
        out.append(y * ref_go.N + x)
        out.append(y * ref_go.N + ref_go.N - 1 - x)
    return np.stack(out)


D8 = _d8()
#: the last-move planes, which the pipeline zeroes in some examples
LAST_MOVES = (3, 4)


def bank_matches(bank: tuple, rows: list, most: int = 4) -> list:
    """For each batch row ``(planes NHWC, labels)``, up to ``most``
    ``(bank row, symmetry)`` pairs of which it is the symmetric copy: the
    planes but the last moves', and every label (a position that opens
    many games is told apart by its game's labels)."""
    feats, labels = bank
    n, c = feats.shape[0], feats.shape[-1]
    dev = feats.device
    keep = [k for k in range(c) if k not in LAST_MOVES]
    flat = feats.reshape(n, ref_go.NN, c)[:, :, keep]
    out = []
    for x, lab in rows:
        x = x.reshape(ref_go.NN, c)[:, keep].to(dev, feats.dtype)
        lab = {k: v.to(dev) for k, v in lab.items()}
        found = []
        for s, perm in enumerate(D8):
            perm = torch.as_tensor(perm, device=dev)
            src = torch.empty_like(x)
            src[perm] = x
            pol = lab["policy"].clone()
            pol[perm] = lab["policy"][:ref_go.NN]
            own = torch.empty_like(lab["ownership"])
            own[perm] = lab["ownership"]
            eq = ((flat == src[None]).flatten(1).all(1)
                  & (labels["policy"] == pol[None]).all(1)
                  & (labels["ownership"] == own[None]).all(1)
                  & (labels["value"] == lab["value"])
                  & (labels["has_ownership"] == lab["has_ownership"]))
            found += [(int(j), s) for j in torch.nonzero(eq)[:most, 0]]
        out.append(found[:most])
    return out


def _row_agrees(feats, labels, ref_planes, ref_labels, perm) -> bool:
    """The batch row ``feats`` (NHWC) and its labels against the
    reference's planes and labels of its position under the symmetry
    ``perm``: every plane exactly (the last-move planes may be zeroed),
    the value and ownership exactly, the policy to float32 rounding of
    the recorded distribution's sum."""
    x = feats.reshape(ref_go.NN, -1).float().numpy()
    ref = ref_planes[perm]
    rest = [k for k in range(ref.shape[1]) if k not in LAST_MOVES]
    last = x[:, list(LAST_MOVES)]
    if not np.array_equal(x[:, rest], ref[:, rest]) or not (
            np.array_equal(last, ref[:, list(LAST_MOVES)])
            or not last.any()):
        return False
    pol = labels["policy"].float().numpy()
    ref_pol = np.concatenate([ref_labels["policy"][perm],
                              ref_labels["policy"][ref_go.NN:]])
    return (float(np.abs(pol - ref_pol).max()) <= POLICY_ROUNDING
            and float(labels["value"]) == float(ref_labels["value"])
            and np.array_equal(labels["ownership"].float().numpy(),
                               ref_labels["ownership"][perm])
            and float(labels["has_ownership"])
            == float(ref_labels["has_ownership"]))


#: the policy label's rounding: float16 entries summed in float32 in
#: another order than the reference's
POLICY_ROUNDING = 1e-5


def batch_diff(state: State, ctx, picks, matches, per_game: int) -> int:
    """Sampled rows of the checked batches that are no symmetric copy of
    the reference's planes and labels of a position the bank holds: the
    bank's row ``j`` is position ``targets[j // per_game, j % per_game]``
    of the recorded game whose moves the program replayed, found among
    the records by those moves."""
    by_moves = {}
    lines = games.lines(ctx.traffic["games"])
    for i, line in enumerate(lines):
        by_moves.setdefault(ref_sgf.move_key(line), []).append(i)
    moves, targets = state.bank_games[0]
    wrong = 0
    for (b, r), found in zip(picks, matches):
        feats, labels = state.batches[b]
        labels = {k: v[r] for k, v in labels.items()}
        ok = False
        for j, s in found:
            g, k = divmod(j, per_game)
            row = [int(m) for m in moves[g]]
            while row and row[-1] == ref_go.PASS:
                row.pop()
            pos = int(targets[g, k])
            for i in by_moves.get(tuple(row), [])[:2]:
                game = ref_sgf.parse(lines[i])
                board = ref_go.replay(game.moves[:pos], game.komi,
                                      ctx.traffic["history_len"])
                if _row_agrees(feats[r], labels, ref_go.v1_planes(board),
                               ref_sgf.labels(game, pos), D8[s]):
                    ok = True
                    break
            if ok:
                break
        wrong += int(not ok)
    return wrong


def _norm_gaps(prog: dict, ref: dict, keep) -> dict:
    """Per leaf, the gap of the program's norm from the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].double().norm()) - norms[k])
            / max(norms[k], med, 1e-30) for k in keep}


def _worst(gaps: dict) -> list:
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:3]


def step_gaps(state: State, ctx, model_cfg: dict, labels_of=None) -> dict:
    """The reference's steps of ``model_cfg`` on the checked batches, and
    the gaps of the program's losses, first gradients and changes; with
    ``ctx.control`` also those of the float8 reference, under
    ``"control"``."""
    dev = ctx.device
    cfg = dict(model_cfg["train"])
    blocks = model_cfg["num_blocks"]
    batches = []
    for feats, labels in state.batches:
        labels = {k: v.to(dev) for k, v in labels.items()}
        if labels_of is not None:
            labels = labels_of(labels)
        batches.append((feats.to(dev).permute(0, 3, 1, 2).contiguous(),
                        labels))
    p0 = {k: v.to(dev) for k, v in state.params0.items()}
    to_cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    with ref_tower.float32():
        ref = ref_tower.train_steps(p0, batches, blocks, cfg)
        low = (ref_tower.train_steps(p0, batches, blocks, cfg, ref_tower.fp8)
               if ctx.control else None)
    ref_grad, ref_params = to_cpu(ref["grad1"]), to_cpu(ref["params"])
    norms = {k: float(v.norm()) for k, v in ref_grad.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, n in norms.items() if n >= 1e-3 * med]
    d_ref = {k: ref_params[k] - state.params0[k] for k in keep}

    def gaps(losses, grad1, params):
        d = {k: params[k] - state.params0[k] for k in keep}
        g, dd = _norm_gaps(grad1, ref_grad, keep), _norm_gaps(d, d_ref, keep)
        return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                                for a, b in zip(losses, ref["losses"])),
                "loss1_gap": abs(losses[0] - ref["losses"][0])
                / abs(ref["losses"][0]),
                "grad_gap": max(g.values()),
                "grad_gap_median": float(np.median(list(g.values()))),
                "delta_gap": max(dd.values()),
                "delta_gap_median": float(np.median(list(dd.values()))),
                "worst": {"grad": _worst(g), "delta": _worst(dd)},
                "leaves": {"grad": g, "delta": dd}}

    out = gaps(state.losses, state.grad1, state.params3)
    out["left_out"] = len(norms) - len(keep)
    if low is not None:
        out["control"] = gaps(low["losses"], to_cpu(low["grad1"]),
                              to_cpu(low["params"]))
        del out["control"]["worst"]
        out["control_leaves"] = out["control"].pop("leaves")
    return out


def check(state: State, ctx, record) -> list[Check]:
    limits = ctx.traffic["limits"]
    rng = np.random.default_rng(ctx.seed ^ 0xBA4C)
    picks = [(b, int(r)) for b in range(len(state.batches))
             for r in np.sort(rng.choice(state.feed.batch_size,
                                         ctx.traffic["check"]["batch_rows"],
                                         replace=False))]
    matches = bank_matches(state.source.build_bank(),
                           [(state.batches[b][0][r],
                             {k: v[r] for k, v in state.batches[b][1]
                              .items()}) for b, r in picks])
    per_game = state.source.positions_per_game
    state.trainer = state.source = state.feed = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    gaps = step_gaps(state, ctx, ctx.config)
    record["left_out_leaves"] = gaps.pop("left_out")
    record["worst_leaves"] = gaps.pop("worst")
    record["leaf_gaps"] = {"program": gaps.pop("leaves"),
                           "control": gaps.pop("control_leaves", None)}
    if "control" in gaps:
        record["control"] = gaps.pop("control")
    gaps["batch_diff"] = batch_diff(state, ctx, picks, matches, per_game)
    return checks(gaps, limits, record)
