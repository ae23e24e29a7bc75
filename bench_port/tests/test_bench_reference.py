"""The plain reference against the program at tiny widths on the CPU: the
rules, planes and candidate masks, the tower and the trainer's steps give
the same numbers on the same inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import games, harness, weights
from bench_port.reference import go as ref_go
from bench_port.reference import tower as ref_tower


def _port_state(moves):
    from dream_go_torch.selfplay import replay

    m = torch.as_tensor(np.asarray([list(moves) + [361]], np.int32))
    return replay.states_at(m, torch.as_tensor([len(moves)], dtype=torch.int32),
                            torch.full((1,), 7.5), 64)


def _compare(moves):
    from dream_go_torch.go import benson, features
    from dream_go_torch.go.options import scoring_mask, standard_mask

    state = _port_state(moves)
    board = ref_go.replay(moves)
    assert state.stones[0].tolist() == board.stones
    assert int(state.to_move[0]) == board.to_move
    assert standard_mask(state)[0].numpy().tolist() == \
        ref_go.standard_mask(board).tolist()
    assert scoring_mask(state)[0].numpy().tolist() == \
        ref_go.scoring_mask(board).tolist()
    assert bool(benson.is_scorable(state)[0]) == ref_go.is_scorable(board)
    planes = features.features_v1(state)[0].reshape(361, 32).numpy()
    np.testing.assert_array_equal(planes, ref_go.v1_planes(board))
    return board


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rules_on_random_games(seed):
    rng = np.random.default_rng(seed)
    board, moves = ref_go.Board(), []
    for i in range(160):
        legal = np.flatnonzero(ref_go.standard_mask(board)[:361])
        if not len(legal):
            break
        moves.append(int(rng.choice(legal)))
        board.play(moves[-1])
        if i % 40 == 39:
            _compare(moves)


@pytest.mark.parametrize("game", [0, 5, 200])
def test_rules_on_recorded_games(game):
    spec = harness.load_json("traffic", "selfplay_b1024_r1600")["games"][:1]
    moves = games.moves(games.lines(spec)[game])
    for at in (len(moves) // 2, len(moves)):
        _compare(list(moves[:at]))


def _dg_cfg():
    cfg = harness.load_json("configs", "dg128x9")
    cfg.update(num_channels=8, num_blocks=2)
    return cfg


def test_tower_forward():
    from dream_go_torch.config import ModelConfig
    from dream_go_torch.models import tower as T

    cfg = _dg_cfg()
    w = weights.make(weights.dg_shapes(cfg, train=False), 3, "cpu")
    model = T.Tower(ModelConfig(num_channels=8, num_blocks=2))
    model.load_state_dict(w)
    x = torch.rand(4, 32, 19, 19).round()
    with torch.no_grad():
        got = model(x)
    ref = ref_tower.forward(w, x, 2)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


class _Batches:
    def __init__(self, batches):
        self.batches_ = list(batches)
        self.batch_size = batches[0][0].shape[0]
        self.device = torch.device("cpu")

    def batches(self, n, rows=None):
        for _ in range(n):
            yield self.batches_.pop(0)


def test_train_steps():
    from bench_port.runners import train

    cfg = _dg_cfg()
    trainer, w = train.make_trainer(cfg, 5, "cpu")
    rng = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(3):
        x = torch.randint(0, 2, (16, 19, 19, 32), generator=rng).float()
        pol = torch.rand(16, 362, generator=rng)
        labels = {"policy": pol / pol.sum(1, keepdim=True),
                  "value": torch.randint(0, 2, (16,), generator=rng) * 2.0
                  - 1.0,
                  "ownership": torch.randint(-1, 2, (16, 361),
                                             generator=rng).float(),
                  "has_ownership": torch.ones(16)}
        batches.append((x, labels))
    losses = [float(trainer.fit(_Batches([b]), 1, log_every=0)["loss"])
              for b in batches]
    ref = ref_tower.train_steps(
        w, [(x.permute(0, 3, 1, 2), lab) for x, lab in batches], 2,
        cfg["train"])
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k, p in trainer.model.named_parameters():
        torch.testing.assert_close(p.detach(), ref["params"][k], rtol=1e-4,
                                   atol=1e-5)


def test_fp8_control_rounds():
    x = torch.linspace(-3, 3, 1001)
    y = ref_tower.fp8(x)
    assert 0 < float((x - y).abs().max()) <= 3 / 16
