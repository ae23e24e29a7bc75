"""Input pipeline: big-SGF lines -> training example batches (port of
`dream_go_tpu/train/pipeline.py`).

SGF parsing, the position draw and the labels happen on the host, in
numpy, as in the JAX package, so both make the same host arrays from the
same seed; board replay, the feature planes and the D8 augmentation run
batched on the device, with the augmentation's draws from a
``torch.Generator``.  Reference semantics (`input_fn.py`,
`sgf_to_features.cc`, `extract_example.rs`):

- one example per game line per visit, its position drawn with the
  value-weighted distribution favouring |v - 0.5| close to 0
  (`extract_example.rs:235-266`);
- a scored game lacking its final passes gets two (`:199-214`); games
  shorter than 30 moves are dropped (`:216-219`);
- policy label: the recorded search distribution (P[...]) with the residual
  mass added at the played move, else a one-hot of the played move
  (`sgf_to_features.cc:240-241`);
- value label +1 if the player to move won else -1; ownership +-1 relative
  to the player to move from TB/TW (`extract_example.rs:329-371`);
- a random D8 symmetry of features, policy and ownership, and 5% history
  plane dropout (`input_fn.py:101-138`);
- with ``lz_history`` (distillation), each example also carries its
  leela-zero planes, ``labels["lz_features"]`` f32[B, 19, 19, 18], under
  the same symmetry; the history ring is single-target, so that source
  replays ``batch_size`` fresh games every batch (one position each, no
  bank).

On ``cuda`` the V1 planes come from the feature kernel and planes 30/31
from the exact ladder kernel; on the CPU from the plain planes and the
greedy reader, as the JAX package resolves ``ladders_exact=None`` per
backend (`features.py:174-187`).  A batch's planes are extracted
``FEATURE_CHUNK`` boards at a time, which changes no bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..go import engine, features
from ..go.engine import GoState
from ..go.topology import SYM
from ..selfplay.replay import (lz_features, states_and_stone_history_at,
                               states_at, states_at_multi)
from ..utils import sgf, spans

#: boards a feature extraction takes at a time: the batch at which the
#: card's tests and smoke hold the kernels, and a bound on the memory of
#: the plain parts of the planes
FEATURE_CHUNK = 1024
#: the share of V1 examples whose last-move planes 3 and 4 are zeroed
HISTORY_DROPOUT = 0.05


@dataclasses.dataclass
class ParsedGame:
    moves: np.ndarray          # int32[T]
    colors: np.ndarray         # int8[T] 1/2 per move
    values: np.ndarray         # f32[T] to-move win rate (nan if absent)
    policies: list             # list[None | f16[362]]
    winner: int
    komi: float
    ownership: np.ndarray      # int8[361] 0/1/2 (absolute colors)


def parse_game(line: str) -> ParsedGame | None:
    game = sgf.parse_line(line)
    if game is None:
        return None
    moves = [m.point for m in game.moves]
    colors = [m.color for m in game.moves]
    values, policies = [], []
    pass_count = 0
    for m in game.moves:
        pass_count = pass_count + 1 if m.point == engine.PASS else 0
        if m.value is None:
            values.append(np.nan)
        else:  # V[] is black-perspective in [-1, 1]
            wr = (m.value + 1.0) / 2.0
            values.append(wr if m.color == 1 else 1.0 - wr)
        policies.append(m.policy)
    # append missing final passes on scored games
    if game.score is not None:
        while pass_count < 2:
            moves.append(engine.PASS)
            colors.append(3 - colors[-1] if colors else 1)
            values.append(np.nan)
            policies.append(None)
            pass_count += 1
    if len(moves) < 30:
        return None
    ownership = np.zeros(361, np.int8)
    ownership[game.black_territory] = 1
    ownership[game.white_territory] = 2
    return ParsedGame(
        moves=np.asarray(moves, np.int32),
        colors=np.asarray(colors, np.int8),
        values=np.asarray(values, np.float32),
        policies=policies, winner=game.winner, komi=game.komi,
        ownership=ownership)


def choose_position(game: ParsedGame, rng: np.random.Generator) -> int:
    """Value-weighted position choice (`extract_example.rs:235-266`).
    When any position has a recorded policy, only those are candidates."""
    has_policy = any(p is not None for p in game.policies)
    cand = [i for i in range(len(game.moves))
            if not has_policy or game.policies[i] is not None]
    w = np.empty(len(cand))
    for j, i in enumerate(cand):
        v = game.values[i]
        w[j] = 0.5 if np.isnan(v) else 0.6 - abs(v - 0.5)
    w = np.maximum(w, 1e-6)
    return int(cand[rng.choice(len(cand), p=w / w.sum())])


def make_labels(game: ParsedGame, pos: int) -> dict:
    """Host-side labels for the example at position ``pos``."""
    color = int(game.colors[pos])
    policy = np.zeros(362, np.float32)
    blob = game.policies[pos]
    if blob is not None:
        policy[:] = np.asarray(blob[:362], np.float32)
    total = float(policy.sum())
    policy[game.moves[pos]] += max(0.0, 1.0 - total)

    value = 1.0 if game.winner == color else -1.0
    if game.winner == 0:
        value = 0.0

    own = np.zeros(361, np.float32)
    own[game.ownership == color] = 1.0
    own[game.ownership == (3 - color)] = -1.0
    return dict(policy=policy, value=np.float32(value), ownership=own,
                has_ownership=np.float32(1.0 if game.ownership.any() else 0.0))


class ExampleSource:
    """Shuffled example batches from big-SGF lines, on ``device``.

    - per-batch (``bank_games=0``): every batch replays ``batch_size //
      positions_per_game`` fresh games and draws ``positions_per_game``
      value-weighted positions from each;
    - banked (``bank_games > 0``): one replay of ``bank_games`` games
      builds an example bank (features before augmentation, and labels)
      on the device; each batch gathers rows of it and augments them.

    ``use_native=None`` takes the C++ extractor (:mod:`..native`) where
    ``g++`` exists.  ``self.gen`` draws the augmentation, ``self.rng`` (numpy)
    everything on the host.  ``lz_history`` adds the leela-zero planes to
    the labels and forces one position a game and no bank."""

    def __init__(self, lines: list[str], batch_size: int, seed: int = 0,
                 history_len: int = 16, augment: bool = True,
                 ladder_features: bool = False, lz_history: bool = False,
                 use_native: bool | None = None, feature_set: str = "v1",
                 positions_per_game: int = 1, bank_games: int = 0,
                 device="cuda"):
        self.ladder_features = ladder_features
        self.lz_history = lz_history
        self.feature_set = feature_set
        if lz_history:
            positions_per_game = 1  # the history ring is single-target
            bank_games = 0
        while batch_size % positions_per_game:
            positions_per_game -= 1  # largest divisor of the batch size
        self.positions_per_game = positions_per_game
        self.bank_games = bank_games
        self.bank = None
        from .. import native

        if use_native is None:
            use_native = native.available()
        self.use_native = use_native
        if use_native:
            probe = native.extract_batch(lines, seed=1)
            self.lines = [l for l, ok in zip(lines, probe["valid"]) if ok]
            self.games = None
            if not self.lines:
                raise ValueError("no usable games")
        else:
            self.games = [g for g in (parse_game(l) for l in lines)
                          if g is not None]
            if not self.games:
                raise ValueError("no usable games")
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.history_len = history_len
        self.augment = augment
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def batches(self, num_batches: int, rows: slice | None = None):
        """``num_batches`` batches of ``(features, labels)``.  With
        ``rows`` (a slice of the batch) each batch is those rows of the
        batch drawn without it: a rank of a mesh draws the whole batch
        from the same seeds as every other rank and keeps its rows (the
        bank's gather and augmentation only for them)."""
        if self.bank_games:
            yield from self._banked_batches(num_batches, rows)
            return
        g = self.batch_size // self.positions_per_game
        for _ in range(num_batches):
            with spans.span("pipeline.batch"):
                feats, labels = _device_batch(
                    *self._on_device(*self._sample_arrays(g)), self.gen,
                    self.history_len, self.augment, self.ladder_features,
                    self.feature_set, self.lz_history)
                if rows is not None:
                    feats, labels = feats[rows], {k: v[rows]
                                                  for k, v in labels.items()}
                spans.count("pipeline.examples", feats.shape[0])
            yield feats, labels

    def build_bank(self):
        """The example bank, ``(features, labels)``, built at the first
        banked batch."""
        if self.bank is None:
            with spans.span("pipeline.bank"):
                self.bank = _device_batch(
                    *self._on_device(*self._sample_arrays(self.bank_games)),
                    self.gen, self.history_len, False, self.ladder_features,
                    self.feature_set)
        return self.bank

    def _banked_batches(self, num_batches: int, rows: slice | None):
        for _ in range(num_batches):
            feats, labels = self.build_bank()
            with spans.span("pipeline.batch"):
                idx = torch.as_tensor(
                    self.rng.integers(0, feats.shape[0], self.batch_size),
                    device=self.device)
                sym = u = None
                if rows is not None:
                    if self.augment:  # the whole batch's draws, in
                        #               _augment's order
                        sym = torch.randint(0, 8, (self.batch_size,),
                                            generator=self.gen,
                                            device=self.device)[rows]
                        u = torch.rand(self.batch_size, generator=self.gen,
                                       device=self.device)[rows]
                    idx = idx[rows]
                batch = _bank_batch(feats, labels, idx, self.gen,
                                    self.augment, self.feature_set, sym, u)
                spans.count("pipeline.examples", idx.shape[0])
            yield batch

    def _on_device(self, moves, targets, komi, labels):
        t = lambda a: torch.as_tensor(a, device=self.device)
        return t(moves), t(targets), t(komi), {k: t(v)
                                               for k, v in labels.items()}

    def _sample_arrays(self, g: int):
        """Host arrays for ``g`` games x K positions: (moves int32[G, T],
        targets int32[G, K], komi f32[G], labels dict of [G*K, ...])."""
        k = self.positions_per_game
        if self.use_native:
            from .. import native
            idx = self.rng.integers(0, len(self.lines), g)
            lines = [self.lines[i] for i in idx]
            # K independent value-weighted position draws per game: one
            # device replay serves K examples per game (states_at_multi)
            outs = [native.extract_batch(
                lines, seed=int(self.rng.integers(1, 2**62)))
                for _ in range(k)]
            out = outs[0]
            t_max = int(out["num_moves"].max())
            t_max = ((t_max + 127) // 128) * 128
            targets = np.stack([o["targets"] for o in outs], axis=1)
            label_of = lambda key: np.stack(
                [o[key] for o in outs], axis=1).reshape(
                    (g * k,) + out[key].shape[1:])
            labels = {key: label_of(key) for key in
                      ("policy", "value", "ownership", "has_ownership")}
            return out["moves"][:, :t_max], targets, out["komi"], labels

        games = [self.games[i]
                 for i in self.rng.integers(0, len(self.games), g)]
        t_max = max(len(gm.moves) for gm in games)
        t_max = ((t_max + 127) // 128) * 128
        moves = np.full((g, t_max), engine.PASS, np.int32)
        targets = np.zeros((g, k), np.int32)
        komi = np.zeros(g, np.float32)
        labels = dict(policy=np.zeros((g * k, 362), np.float32),
                      value=np.zeros(g * k, np.float32),
                      ownership=np.zeros((g * k, 361), np.float32),
                      has_ownership=np.zeros(g * k, np.float32))
        for row, gm in enumerate(games):
            moves[row, :len(gm.moves)] = gm.moves
            komi[row] = gm.komi
            for j in range(k):
                pos = choose_position(gm, self.rng)
                targets[row, j] = pos
                ex = make_labels(gm, pos)
                for key in labels:
                    labels[key][row * k + j] = ex[key]
        return moves, targets, komi, labels


def planes(states: GoState, ladder_features: bool,
           feature_set: str = "v1") -> torch.Tensor:
    """The network input of ``states``, ``FEATURE_CHUNK`` boards at a time:
    the kernels on ``cuda``, the plain planes and greedy ladders on the
    CPU."""
    cuda = states.stones.device.type == "cuda"
    return torch.cat([
        features.extract_batch(states.index(slice(i, i + FEATURE_CHUNK)),
                               ladder_features, cuda, cuda,
                               feature_set=feature_set)
        for i in range(0, states.batch, FEATURE_CHUNK)])


def _device_batch(moves, targets, komi, labels, gen, history_len, augment,
                  ladder_features=False, feature_set="v1", lz_history=False):
    """Replay -> features -> random D8 augmentation + history dropout.

    ``targets`` may be int32[G] (one example per replayed game) or
    int32[G, K] (K examples per replay: the batch is G*K examples in
    game-major order, as the host's labels are).  With ``lz_history`` the
    labels gain ``lz_features``, the leela-zero planes of the first target
    of each game."""
    if lz_history:
        if targets.dim() == 2:
            targets = targets[:, 0]
        states, hist = states_and_stone_history_at(moves, targets, komi,
                                                   history_len)
        labels = dict(labels, lz_features=lz_features(states, hist))
    elif targets.dim() == 2:
        g, k = targets.shape
        states = states_at_multi(moves, targets, komi, history_len)
        states = GoState(**{name: v.reshape((g * k,) + v.shape[2:])
                            for name, v in states.fields().items()})
    else:
        states = states_at(moves, targets, komi, history_len)
    feats = planes(states, ladder_features, feature_set)
    if not augment:
        return feats, labels
    return _augment(feats, labels, gen, feature_set)


def _augment(feats, labels, gen, feature_set, sym=None, u=None):
    """A random D8 symmetry per example, and for V1 the last-move planes
    3 and 4 zeroed in 5% of the examples.  ``sym`` (long[B], 0..7) and
    ``u`` (f32[B] uniform in [0, 1)) are the draws; those not given are
    drawn from ``gen``, ``sym`` first."""
    b = feats.shape[0]
    if sym is None:
        sym = torch.randint(0, 8, (b,), generator=gen, device=feats.device)
    if u is None:
        u = torch.rand(b, generator=gen, device=feats.device)
    sym = sym.long()
    perm = torch.as_tensor(SYM, dtype=torch.long, device=feats.device)[sym]
    feats = features.apply_symmetry(feats, sym)
    pol = labels["policy"]
    labels = dict(labels, policy=torch.cat(
        [torch.take_along_dim(pol[:, :361], perm, 1), pol[:, 361:]], 1),
        ownership=torch.take_along_dim(labels["ownership"], perm, 1))
    if "lz_features" in labels:
        lz = labels["lz_features"].reshape(b, 361, 18)
        labels["lz_features"] = torch.take_along_dim(
            lz, perm[:, :, None], 1).reshape(b, 19, 19, 18)
    if feature_set == "v1":
        keep = torch.ones(feats.shape[-1], device=feats.device)
        keep[3:5] = 0.0
        drop = u < HISTORY_DROPOUT
        feats = torch.where(drop[:, None, None, None], feats * keep, feats)
    return feats, labels


def _bank_batch(bank_feats, bank_labels, idx, gen, augment, feature_set,
                sym=None, u=None):
    """One batch gathered from the example bank, augmented as the
    per-batch path is (with the draws ``sym`` and ``u`` where given)."""
    feats = bank_feats[idx]
    labels = {k: v[idx] for k, v in bank_labels.items()}
    if not augment:
        return feats, labels
    return _augment(feats, labels, gen, feature_set, sym, u)
