"""The port's tools (`dream_go_torch/tools/`) against the JAX package's
(`tools/`, loaded by file path): the arena's Elo fit and move function,
``eval_accuracy``, ``train_supervised`` and ``sgf2score`` /
``sgf2territory`` on the repository's files."""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu.config import ModelConfig as JMC
from dream_go_tpu.config import TrainConfig as JTC
from dream_go_tpu.go import benson as jbn
from dream_go_tpu.go import engine as jeng
from dream_go_tpu.go.options import scoring_mask as jscoring_mask
from dream_go_tpu.models import tower as JT
from dream_go_tpu.train import losses as JL
from dream_go_tpu.train import train_loop as JTL
from dream_go_torch.config import ModelConfig, TrainConfig
from dream_go_torch.models import params as TP
from dream_go_torch.models import tower as TT
from dream_go_torch.tools import arena as tarena
from dream_go_torch.tools import eval_accuracy as teval
from dream_go_torch.tools import sgf2score as tscore
from dream_go_torch.tools import sgf2territory as tterritory
from dream_go_torch.tools import train_supervised as tsup
from dream_go_torch.train import lr_schedule as TLR
from dream_go_torch.train import train_loop as TTL

ROOT = pathlib.Path(__file__).resolve().parents[1]
RL20 = ROOT / "models" / "rl20"
FIRST8 = ROOT / "tests" / "fixtures" / "rl20_gen0000_first8.sgf"
SAMPLES = ROOT / "tests" / "fixtures" / "sample_games.sgf"
#: a net's float32 outputs in the two packages (`test_torch_model.py`)
VALUE_ATOL = 1e-4
#: eval_accuracy: the two packages' float32 policies differ by ~1e-7; a
#: top-k count may differ only where two of an example's six most likely
#: moves lie within this of each other, which the test checks does not
#: happen on these examples
TIE_ATOL = 1e-6
#: train_supervised's held-out metrics (`test_torch_train.py`)
METRIC_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv, stdin_text=None, monkeypatch=None):
    """``main()`` with ``sys.argv`` and stdin set: its stdout lines."""
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["tool"] + argv)
    if stdin_text is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    with contextlib.redirect_stdout(out):
        rc = main()
    assert not rc
    return out.getvalue().splitlines()


def test_fit_elo_matches_jax():
    with open(RL20 / "arena.sgf") as fh:
        lines = [next(fh) for _ in range(400)]
    want = _jax_tool("arena").fit_elo(lines)
    assert tarena.fit_elo(lines) == want
    assert len(want) > 2


def test_arena_move_matches_jax(tmp_path):
    """One policy move of two rl20 generations (planes off) from boards
    10 to 160 moves in, the cutoff at 1 so that only the best move is
    kept (the two packages' random streams differ): the same mask, move,
    win rate and next boards."""
    for gen in (12, 13):
        shutil.copy(RL20 / f"weights_{gen:04d}.json", tmp_path)
    jtool = _jax_tool("arena")
    (_, ja, cfg), (_, jb, _) = jtool.load_gen_weights(str(tmp_path))
    (_, ta, tcfg), (_, tb, _) = tarena.load_gen_weights(tmp_path, "cpu")
    assert not cfg.ladder_features and not tcfg.ladder_features
    # both in float32 (the JAX tool's nets compute in the config's bf16)
    jmove, _ = jtool.build_move_fn(
        dataclasses.replace(cfg, compute_dtype="float32"), cutoff=1.0)
    tmove, _ = tarena.build_move_fn(tcfg, cutoff=1.0)
    jst = B.random_states(6, [10, 40, 70, 100, 130, 160], seed=3)
    tst = B.to_torch(jst)
    jnext, jm, jv = jmove(ja, jb, jst, jax.random.PRNGKey(0))
    tnext, tm, tv = tmove(ta, tb, tst, torch.Generator().manual_seed(0))
    jmask = jnp.where(jax.vmap(jbn.is_scorable)(jst)[:, None],
                      jeng.legal_mask_batch(jst),
                      jax.vmap(jscoring_mask)(jst))
    np.testing.assert_array_equal(tarena.arena_mask(tst).numpy(),
                                  np.asarray(jmask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VALUE_ATOL,
                               rtol=0)
    B.assert_states_equal(tnext, jnext)


def test_eval_accuracy_matches_jax(monkeypatch):
    """The rl20 run's last weights over the three sample games (the 48
    examples in one batch): the JAX tool's line, with no near-tie among
    any example's likeliest moves.  The port's line is its ``main``'s,
    made here from the same parts."""
    weights = str(RL20 / "dream_go.json")
    want = _run(_jax_tool("eval_accuracy").main,
                [weights, "--games", str(SAMPLES), "--batch", "48"],
                monkeypatch=monkeypatch)
    args = teval.build_parser().parse_args([weights, "--batch", "48",
                                            "--device", "cpu"])
    assert pathlib.Path(args.games) == SAMPLES
    games = teval.load_games(args.games)
    examples = teval.pick_examples(games, args.positions_per_game,
                                   args.seed)
    value, policy = teval.predictions(weights, games, examples, args.batch,
                                      args.device)
    top = -np.sort(-policy, axis=-1)[:, :6]
    assert np.diff(top, axis=-1).max() < -TIE_ATOL
    assert [json.dumps(teval.accuracy_row(weights, examples, value,
                                          policy))] == want
    assert json.loads(want[0])["examples"] == 48


def _jax_metric_names():
    zeros = jnp.zeros
    out = JT.TowerOutput(policy_logits=zeros((2, 362)), value=zeros(2),
                         ownership=zeros((2, 361)))
    labels = dict(policy=zeros((2, 362)), value=zeros(2),
                  ownership=zeros((2, 361)), has_ownership=zeros(2))
    return set(JL.total_loss(out, labels, JTC())[1])


def test_train_supervised_rows_and_evaluation_match_jax(tmp_path):
    """Three steps at 8 x 1 write the JAX tool's row keys (the train row
    with ``Trainer.fit``'s learning-rate keys); the held-out evaluation of
    a trainer carrying JAX ``Trainer.create``'s weights equals JAX's on
    the same held-out batches."""
    metrics, dump = tmp_path / "m.jsonl", tmp_path / "w.json"
    argv = ["--games", str(FIRST8), "--holdout", "2", "--channels", "8",
            "--blocks", "1", "--steps", "3", "--eval-every", "3",
            "--eval-batches", "1", "--batch", "8", "--device", "cpu",
            "--metrics", str(metrics), "--dump", str(dump)]
    assert tsup.main(argv) == 0
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    names = _jax_metric_names()
    assert [(r["step"], r["split"]) for r in rows] == [(3, "train"),
                                                       (3, "holdout")]
    assert set(rows[0]) == {"step", "split", "learning_rate", "lr_slope",
                            "lr_p_decreasing"} | names
    assert set(rows[1]) == {"step", "split"} | names
    assert TP.load_json(dump.read_text())[0].num_channels == 8

    args = tsup.build_parser().parse_args(argv)
    train, holdout = tsup.split_corpus(args)
    batches = list(tsup.make_source(args, holdout, args.seed + 1, "cpu")
                   .batches(2))
    size = dict(num_channels=8, num_blocks=1, num_samples=8,
                compute_dtype="float32")
    jtrainer = JTL.Trainer.create(
        JMC(**size), JTC(batch_size=8), seed=0,
        policy_bias=JTL.policy_bias_from_lines(train))
    cfg = ModelConfig(**size)
    model = TT.TrainTower(cfg)
    model.load_state_dict(TP.from_train_tree(
        cfg, jax.tree_util.tree_map(np.asarray, jtrainer.state.params),
        jax.tree_util.tree_map(np.asarray, jtrainer.state.batch_stats)))
    tcfg = TrainConfig(batch_size=8)
    ttrainer = TTL.Trainer(cfg, tcfg, model, TTL.make_optimizer(model, 1e-3),
                           TLR.LearningRateScheduler(1e-3, 3.0))

    class Fixed:
        def __init__(self, convert):
            self.convert = convert

        def batches(self, n):
            for f, l in batches[:n]:
                yield self.convert(f), {k: self.convert(v)
                                        for k, v in l.items()}

    want = jtrainer.evaluate(Fixed(lambda t: jnp.asarray(t.numpy())), 2)
    got = ttrainer.evaluate(Fixed(lambda t: t), 2)
    assert got.keys() == want.keys() == names
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=METRIC_RTOL, err_msg=k)


@pytest.mark.parametrize("name,port", [("sgf2score", tscore),
                                       ("sgf2territory", tterritory)])
def test_rescoring_tools_match_jax(name, port, monkeypatch):
    """The first eight games of the rl20 run, re-scored and labelled:
    the JAX tool's lines exactly."""
    text = FIRST8.read_text()
    want = _run(_jax_tool(name).main, [], text, monkeypatch)
    got = _run(port.main, ["--device", "cpu"], text, monkeypatch)
    assert len(got) == 8
    assert got == want
