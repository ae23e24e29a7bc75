"""The port's trainer slice against the JAX package: SGF parsing and labels,
the example pipeline, the losses, the train-mode tower, train steps, the
scheduler, the weights dump and the CLI's trainer procedures.  Both
packages run at 16 x 1, B = 8, in float32, on the first eight games of the
rl20 run (`tests/fixtures/rl20_gen0000_first8.sgf`)."""

import contextlib
import copy
import functools
import io
import json
import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread)
from dream_go_tpu import cli as jcli
from dream_go_tpu import native as jnative
from dream_go_tpu.config import ModelConfig as JMC
from dream_go_tpu.config import TrainConfig as JTC
from dream_go_tpu.models import params as JP
from dream_go_tpu.models import tower as JT
from dream_go_tpu.train import losses as JL
from dream_go_tpu.train import lr_schedule as JLR
from dream_go_tpu.train import metrics as JM
from dream_go_tpu.train import pipeline as JPL
from dream_go_tpu.train import train_loop as JTL
from dream_go_torch import cli as tcli
from dream_go_torch import native as tnative
from dream_go_torch.config import ModelConfig, TrainConfig
from dream_go_torch.models import params as TP
from dream_go_torch.models import tower as TT
from dream_go_torch.train import losses as TL
from dream_go_torch.train import lr_schedule as TLR
from dream_go_torch.train import metrics as TM
from dream_go_torch.train import pipeline as TPL
from dream_go_torch.train import train_loop as TTL

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAMES = ROOT / "tests" / "fixtures" / "rl20_gen0000_first8.sgf"
WEIGHTS = ROOT / "models" / "rl20" / "weights_0013.json"
SIZE = dict(num_channels=16, num_blocks=1, num_samples=2,
            compute_dtype="float32")
MCFG, JMCFG = ModelConfig(**SIZE), JMC(**SIZE)
TCFG, JTCFG = TrainConfig(batch_size=8), JTC(batch_size=8)
STEPS = 3
#: the three steps' loss and metrics, both packages in float32
METRIC_RTOL = 1e-4
#: the first step's gradients (float32 convolutions and reductions in two
#: orders), relative to each tensor's largest gradient
GRAD_RTOL = 1e-4
#: running statistics and EMA after three steps, whose parameters carry
#: the Adam caveat below
STATS_TOL = dict(rtol=1e-3, atol=1e-5)
#: Adam's first steps move a weight by ~lr * sign(g): a gradient near zero
#: whose sign differs in its last bits moves it by up to 2 lr a step
ADAM_ATOL = 2 * TCFG.initial_lr * STEPS


@functools.lru_cache(maxsize=None)
def _lines():
    with open(GAMES) as fh:
        return [line.strip() for line in fh if line.strip()]


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _t(labels):
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in labels.items()}


# ---------------------------------------------------------------------------
# parsing, labels, the policy bias


def test_parse_game_and_labels_match_jax():
    for line in _lines():
        j, t = JPL.parse_game(line), TPL.parse_game(line)
        for f in ("moves", "colors", "values", "ownership"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
        assert (t.winner, t.komi) == (j.winner, j.komi)
        assert [p is None for p in t.policies] == \
            [p is None for p in j.policies]
        rj, rt = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(6):
            pos = JPL.choose_position(j, rj)
            assert TPL.choose_position(t, rt) == pos
            lj, lt = JPL.make_labels(j, pos), TPL.make_labels(t, pos)
            for k in lj:
                np.testing.assert_array_equal(lt[k], lj[k], k)
    np.testing.assert_array_equal(TTL.policy_bias_from_lines(_lines()),
                                  JTL.policy_bias_from_lines(_lines()))


def test_native_extraction_matches_jax():
    if not jnative.available():
        pytest.skip("no C++ toolchain for the JAX package's loader")
    lines = _lines() + ["(;GM[1]KM[7.5];B[aa];W[bb])", "not an sgf"]
    for seed in (1, 7):
        want = jnative.extract_batch(lines, seed)
        got = tnative.extract_batch(lines, seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)


# ---------------------------------------------------------------------------
# the pipeline

#: per-batch with K = 1 and K = 4, banked, and the native host path (the
#: ladder planes, which the pipeline takes from ``extract_batch``, are held
#: against JAX in test_torch_ladder and test_torch_features)
MODES = {
    "k1": dict(positions_per_game=1),
    "k4": dict(positions_per_game=4),
    "banked": dict(positions_per_game=4, bank_games=3),
    "native": dict(positions_per_game=4, use_native=True),
}


@pytest.mark.parametrize("mode", MODES)
def test_example_batches_match_jax(mode):
    kw = dict(dict(use_native=False), **MODES[mode])
    js = JPL.ExampleSource(_lines(), 8, seed=5, augment=False, **kw)
    ts = TPL.ExampleSource(_lines(), 8, seed=5, augment=False, device="cpu",
                           **kw)
    n = 2 if kw.get("bank_games") else 1
    for (fj, lj), (ft, lt) in zip(js.batches(n), ts.batches(n)):
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        assert set(lt) == set(lj)
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), k)


def _draws(key, b):
    """JAX's augmentation draws from ``key`` (`pipeline.py:290-293`)."""
    k_sym, k_hist = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.randint(k_sym, (b,), 0, 8))),
            torch.tensor(np.asarray(jax.random.uniform(k_hist, (b,)))))


def test_augment_matches_jax_draws():
    """Random planes and labels at B = 256 (so that the 5% history dropout
    hits), one JAX key: JAX's ``_augment`` and the port's fed its draws."""
    rng = np.random.default_rng(0)
    b = 256
    feats = rng.random((b, 19, 19, 32), dtype=np.float32)
    labels = dict(policy=rng.random((b, 362), dtype=np.float32),
                  value=rng.choice([-1.0, 1.0], b).astype(np.float32),
                  ownership=rng.integers(-1, 2, (b, 361)).astype(np.float32),
                  has_ownership=np.ones(b, np.float32))
    key = jax.random.PRNGKey(11)
    fj, lj = JPL._augment(jnp.asarray(feats),
                          {k: jnp.asarray(v) for k, v in labels.items()},
                          key, "v1")
    sym, u = _draws(key, b)
    assert (u < 0.05).any() and len(set(sym.tolist())) == 8
    ft, lt = TPL._augment(torch.from_numpy(feats), _t(labels), None, "v1",
                          sym, u)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for k in lj:
        np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), k)


def test_banked_augmented_batch_matches_jax_draws():
    """JAX's first augmented banked batch against the port's gathered rows
    (equal banks, equal numpy draws of the rows) augmented with JAX's
    draws from its source's key."""
    kw = dict(use_native=False, positions_per_game=4, bank_games=3)
    fj, lj = next(iter(JPL.ExampleSource(_lines(), 8, seed=9, **kw)
                       .batches(1)))
    ft, lt = next(iter(TPL.ExampleSource(_lines(), 8, seed=9, augment=False,
                                         device="cpu", **kw).batches(1)))
    _, sub = jax.random.split(jax.random.PRNGKey(9))
    ft, lt = TPL._augment(ft, lt, None, "v1", *_draws(sub, 8))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for k in lj:
        np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), k)


# ---------------------------------------------------------------------------
# losses and the train-mode tower


def test_losses_and_tied_accuracies_match_jax():
    rng = np.random.default_rng(2)
    b = 16
    # integer logits: many ties, ranked as a stable argsort ranks them
    logits = rng.integers(-3, 4, (b, 362)).astype(np.float32)
    logits[::2, 7] = 4.0       # a top-1 hit, where 7 is the target
    logits[1::4, 7] = 3.0      # tied with the others at 3
    value = np.tanh(rng.normal(size=b)).astype(np.float32)
    own = np.tanh(rng.normal(size=(b, 361))).astype(np.float32)
    own[:, :40] = 0.0
    pol = rng.random((b, 362), dtype=np.float32)
    pol[::2, 7] = pol[1::4, 7] = 2.0
    pol /= pol.sum(-1, keepdims=True)
    labels = dict(policy=pol, value=rng.choice([-1.0, 1.0], b)
                  .astype(np.float32),
                  ownership=rng.integers(-1, 2, (b, 361)).astype(np.float32),
                  has_ownership=(np.arange(b) % 3 > 0).astype(np.float32))
    out_j = JT.TowerOutput(policy_logits=jnp.asarray(logits),
                           value=jnp.asarray(value), ownership=jnp.asarray(own))
    _, mj = JL.total_loss(out_j, {k: jnp.asarray(v) for k, v in
                                  labels.items()}, JTCFG)
    _, mt = TL.total_loss(tuple(torch.from_numpy(a)
                                for a in (logits, value, own)),
                          _t(labels), TCFG)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6,
                                   err_msg=k)
    assert 0 < float(mt["policy_top1"]) < float(mt["policy_top5"]) < 1


@functools.lru_cache(maxsize=None)
def _jax_weights():
    """The JAX trainer's initial training trees (:func:`_jax_run`) with
    random running statistics."""
    params, stats = _jax_run()[:2]
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, x: (np.abs(rng.normal(1.0, 0.3, x.shape)) + 0.1
                         if path[-1].key == "var"
                         else rng.normal(0.0, 0.3, x.shape)).astype(
                             np.float32), stats)
    return params, stats


def _train_tower(params, stats) -> TT.TrainTower:
    model = TT.TrainTower(MCFG)
    model.load_state_dict(TP.from_train_tree(MCFG, params, stats))
    return model


def test_train_tower_matches_jax_and_folds():
    """Eval mode against JAX's ``apply_tower(train=False)`` and against the
    folded inference ``Tower`` (1e-5); train mode's outputs and new running
    statistics against JAX's (a ``running_var`` from the unbiased
    variance would be off by 1/2887)."""
    params, stats = _jax_weights()
    x = np.random.default_rng(5).random((8, 19, 19, 32), dtype=np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    model = _train_tower(params, stats).eval()
    with torch.no_grad():
        got = model(xt)
        folded = TT.from_state_dict(MCFG, TP.fold_train(MCFG,
                                                        model.state_dict()),
                                    "cpu", "float32")(xt)
    want, _ = JT.apply_tower(JMCFG, params, stats, jnp.asarray(x))
    for a, f, w in zip(got, folded, (want.policy_logits, want.value,
                                     want.ownership)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(f.numpy(), a.numpy(), atol=1e-5)

    model.train()
    with torch.no_grad():
        got = model(xt)
    want, new_stats = JT.apply_tower(JMCFG, params, stats, jnp.asarray(x),
                                     train=True)
    for a, w in zip(got, (want.policy_logits, want.value, want.ownership)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    _, st = TP.to_train_tree(MCFG, model.state_dict())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7),
        st, _np(new_stats))


def test_dump_json_is_byte_equal_to_jax():
    params, stats = _jax_weights()
    want = JP.dump_json(JMCFG, params, stats)
    sd = TP.from_train_tree(MCFG, params, stats)
    assert TP.dump_json(MCFG, *TP.to_train_tree(MCFG, sd)) == want
    trainer = TTL.Trainer(MCFG, TCFG, _train_tower(params, stats), None,
                          None, ema={k: v for k, v in sd.items()
                                     if not k.endswith((".mean", ".var"))})
    assert trainer.dump_json() == want
    cfg, folded = TP.load_json(want)
    assert (cfg.num_channels, cfg.num_blocks) == (16, 1)
    np.testing.assert_array_equal(
        TP.decode_raw(want)["02_residual/alpha:0"],
        JP.decode_raw(want)["02_residual/alpha:0"])


def test_norm_summaries_cover_every_parameter():
    params, stats = _jax_weights()
    model = _train_tower(params, stats)
    got = TM.norm_summaries(model.named_parameters())
    want = JM.norm_summaries(params)
    total = lambda d: sum(float(v) ** 2 for v in d.values())
    np.testing.assert_allclose(total(got), total(want), rtol=1e-5)
    assert {"norm/upsample", "norm/blocks.0", "norm/policy_linear"} <= set(got)


# ---------------------------------------------------------------------------
# train steps


@functools.lru_cache(maxsize=None)
def _batches():
    """Three fixed augmented batches (the port's banked source)."""
    src = TPL.ExampleSource(_lines(), 8, seed=1, positions_per_game=4,
                            bank_games=4, use_native=False, device="cpu")
    return [(f.numpy(), {k: v.numpy() for k, v in l.items()})
            for f, l in src.batches(STEPS)]


class _Fixed:
    """A source of the fixed batches, as one package takes them."""

    def __init__(self, convert):
        self.convert = convert

    def batches(self, n):
        for feats, labels in _batches()[:n]:
            yield self.convert(feats), {k: self.convert(v)
                                        for k, v in labels.items()}


def _fit(trainer, convert):
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/metrics.jsonl"
        trainer.fit(_Fixed(convert), STEPS, metrics_path=path)
        with open(path) as fh:
            return [json.loads(line) for line in fh]


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX: the first step's gradients, then three steps of ``fit``."""
    bias = JTL.policy_bias_from_lines(_lines())
    # Trainer.create, with the initialisation compiled (eager, it takes
    # seconds)
    state = jax.jit(lambda key: JTL.init_state(JMCFG, key, bias))(
        jax.random.PRNGKey(0))
    trainer = JTL.Trainer(
        JMCFG, JTCFG, state,
        JLR.LearningRateScheduler(JTCFG.initial_lr, JTCFG.lr_decay),
        ema_params=jax.tree_util.tree_map(
            lambda p: jnp.copy(p.astype(jnp.float32)), state.params))
    params0, stats0 = _np(trainer.state.params), _np(trainer.state.batch_stats)
    feats, labels = _batches()[0]

    def loss_fn(p):
        out, _ = JT.apply_tower(JMCFG, p, trainer.state.batch_stats,
                                jnp.asarray(feats), train=True)
        return JL.total_loss(out, {k: jnp.asarray(v) for k, v in
                                   labels.items()}, JTCFG)[0]

    grads = _np(jax.jit(jax.grad(loss_fn))(trainer.state.params))
    metrics = _fit(trainer, jnp.asarray)
    return (params0, stats0, grads, metrics, _np(trainer.state.params),
            _np(trainer.state.batch_stats), _np(trainer.ema_params))


def _port_trainer(params, stats, remat=False) -> TTL.Trainer:
    cfg = ModelConfig(**SIZE, remat=remat)
    model = TT.TrainTower(cfg)
    model.load_state_dict(TP.from_train_tree(cfg, params, stats))
    return TTL.Trainer(cfg, TCFG, model.train(),
                       TTL.make_optimizer(model, TCFG.initial_lr),
                       TLR.LearningRateScheduler(TCFG.initial_lr,
                                                 TCFG.lr_decay),
                       ema={k: p.detach().clone()
                            for k, p in model.named_parameters()})


def _close_max(got, want, rtol, what):
    """|got - want| <= rtol * max |want|, tensor by tensor."""
    for (name, a), b in zip(got, want):
        scale = float(np.abs(b).max()) or 1.0
        np.testing.assert_allclose(a, b, atol=rtol * scale, rtol=0,
                                   err_msg=f"{what} {name}")


def test_train_steps_match_jax():
    params0, stats0, grads, metrics_j, params_j, stats_j, ema_j = _jax_run()

    # the first step's gradients
    trainer = _port_trainer(params0, stats0)
    probe = copy.deepcopy(trainer.model)
    feats, labels = _batches()[0]
    out = probe(torch.from_numpy(feats).permute(0, 3, 1, 2))
    TL.total_loss(out, _t(labels), TCFG)[0].backward()
    want = TP.from_train_tree(MCFG, grads, stats0)
    _close_max([(k, p.grad.numpy()) for k, p in probe.named_parameters()],
               [want[k].numpy() for k, _ in probe.named_parameters()],
               GRAD_RTOL, "gradient")

    # three steps of fit
    metrics_t = _fit(trainer, torch.from_numpy)
    assert [m["step"] for m in metrics_t] == [1, 2, 3]
    for mt, mj in zip(metrics_t, metrics_j):
        for k, v in mj.items():
            if k not in ("step", "time"):
                np.testing.assert_allclose(mt[k], v, rtol=METRIC_RTOL,
                                           err_msg=k)
    p_t, s_t = TP.to_train_tree(MCFG, trainer.model.state_dict())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, **STATS_TOL),
        s_t, stats_j)
    ema = TP.to_train_tree(MCFG, dict(trainer.model.state_dict(),
                                      **trainer.ema))[0]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, **STATS_TOL),
        ema, ema_j)
    moved = []

    def adam(a, b):
        np.testing.assert_allclose(a, b, rtol=0, atol=ADAM_ATOL)
        moved.append(np.mean(np.abs(a - b) <= 1e-5))

    jax.tree_util.tree_map(adam, p_t, params_j)
    assert np.mean(moved) > 0.95, moved


def test_remat_equals_no_remat():
    """Per-block recomputation changes no bit of a step, and the running
    statistics move once a step, not again in the recomputation."""
    params0, stats0, *_ = _jax_run()
    runs = []
    for remat in (False, True):
        trainer = _port_trainer(params0, stats0, remat)
        _fit(trainer, torch.from_numpy)
        runs.append(trainer.model.state_dict())
    for k, v in runs[0].items():
        assert torch.equal(runs[1][k], v), k
    assert not torch.equal(runs[0]["upsample.bn.mean"],
                           torch.tensor(stats0["upsample"]["bn"]["mean"]))


def test_lr_schedule_trajectory_matches_jax():
    rng = np.random.default_rng(0)
    losses = np.concatenate([np.linspace(3.0, 2.0, 1500),
                             2.0 + 0.05 * rng.normal(size=5000)])
    j, t = JLR.LearningRateScheduler(3e-4), TLR.LearningRateScheduler(3e-4)
    lrs = []
    for loss in losses:
        lrs.append(t.update(float(loss)))
        assert lrs[-1] == j.update(float(loss))
        assert (t.slope, t.p_decreasing) == (j.slope, j.p_decreasing)
    assert min(lrs) < 3e-4


def test_save_restore_then_fit_equals_unbroken_fit(tmp_path):
    def source():
        return TPL.ExampleSource(_lines(), 8, seed=2, positions_per_game=4,
                                 bank_games=3, device="cpu")

    def trainer():
        return TTL.Trainer.create(MCFG, TCFG, seed=0, device="cpu")

    whole = trainer()
    whole.fit(source(), 4)
    src, first = source(), trainer()
    first.fit(src, 2)
    first.save(str(tmp_path / "ckpt"))
    resumed = TTL.Trainer.restore(str(tmp_path / "ckpt"), TCFG, "cpu")
    resumed.fit(src, 2)
    assert resumed.step == whole.step == 4
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for k, v in whole.ema.items():
        assert torch.equal(resumed.ema[k], v), k
    np.testing.assert_array_equal(resumed.scheduler.losses,
                                  whole.scheduler.losses)


# ---------------------------------------------------------------------------
# the CLI


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


@pytest.mark.parametrize("names", [[], ["01_upsample/conv_1/offset:0",
                                        "num_blocks:0"]])
def test_print_matches_jax(names):
    argv = ["--print", *names, "--weights", str(WEIGHTS)]
    want = _stdout(jcli.main, ["--cpu", *argv])
    got = _stdout(tcli.main, [*argv, "--device", "cpu"])
    assert got == want


def test_cli_trainer_procedures_on_cpu(tmp_path):
    ckpt, metrics = str(tmp_path / "ckpt"), str(tmp_path / "m.jsonl")
    size = ["--device", "cpu", "--num-channels", "16", "--num-blocks", "1",
            "--batch-size", "8", "--positions-per-game", "4",
            "--bank-games", "3"]
    assert tcli.main(["--start", str(GAMES), "--steps", "3",
                      "--ladder-features", "--checkpoint", ckpt,
                      "--metrics", metrics, *size]) == 0
    assert tcli.main(["--resume", str(GAMES), "--steps", "2",
                      "--checkpoint", ckpt, "--metrics", metrics,
                      *size]) == 0
    with open(metrics) as fh:
        steps = [json.loads(line)["step"] for line in fh]
    assert steps == [1, 2, 3, 4, 5]
    verify = json.loads(_stdout(tcli.main, ["--verify", str(GAMES),
                                            "--checkpoint", ckpt, *size]))
    assert {"loss", "policy_top1", "ownership_accuracy"} <= set(verify)
    assert all(np.isfinite(v) for v in verify.values())
    dumped = _stdout(tcli.main, ["--dump", "--checkpoint", ckpt, *size])
    cfg, _ = TP.load_json(dumped)
    assert (cfg.num_channels, cfg.num_blocks, cfg.ladder_features) == \
        (16, 1, True)


def test_trace_train_window_on_cpu(capsys):
    """``python -m dream_go_torch.trace --train`` rehearsed on the CPU: one
    JSON line with the step's milliseconds (no device time there)."""
    from dream_go_torch import trace

    trace.main(["--train", "--device", "cpu", "--channels", "16",
                "--blocks", "1", "--batch-size", "8", "--bank-games", "3",
                "--train-steps", "2", "--train-data", str(GAMES)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["train"]["steps"] == 2 and line["train"]["ms_per_step"] > 0
