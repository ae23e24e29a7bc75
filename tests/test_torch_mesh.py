"""The port's multi-rank slice against the JAX package and against itself
in one process: the mesh's rank coordinates and game slices, a two-rank
gloo train step (data = 2, then model = 2) of a 16 x 2 tower at global
B = 16 in float32, a checkpoint and dump written under a split policy
head, two-rank policy and search play, ``dryrun_multichip`` and
``entry``.  The ranks run in one spawned group (`_mesh_ranks.py`)."""

import functools
import json
import math
import os
import pathlib
import re
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _mesh_ranks as R
import _torch_bridge as B
import chip_smoke as C
from dream_go_tpu.config import ModelConfig as JMC
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.config import SelfPlayConfig as JSP
from dream_go_tpu.models import tower as JT
from dream_go_tpu.parallel import distributed as JD
from dream_go_tpu.parallel import mesh as JM
from dream_go_tpu.selfplay import search_play as JPL
from dream_go_tpu.train import losses as JL
from dream_go_tpu.train import lr_schedule as JLR
from dream_go_tpu.train import train_loop as JTL
from dream_go_torch import cli as tcli
from dream_go_torch import entry as tentry
from dream_go_torch.config import ModelConfig
from dream_go_torch.models import params as TP
from dream_go_torch.models import tower as TT
from dream_go_torch.parallel import distributed as D
from dream_go_torch.parallel import mesh as M
from dream_go_torch.train import pipeline as TPL
from dream_go_torch.train import train_loop as TTL

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAMES = ROOT / "tests" / "fixtures" / "rl20_gen0000_first8.sgf"
#: JAX computes in float64 (its parameters stay float32): in float32 the
#: first step of this 16 x 2 tower is itself off by up to 1.2e-2 of a
#: tensor's largest gradient in block 0 against float64 (JAX; the port
#: 1.5e-3), as relus near 0 flip, so the exact checks run in float64
JMCFG = JMC(**dict(R.SIZE, compute_dtype="float64"))
JTCFG = JTL.TrainConfig(batch_size=R.BATCH)
#: the float64 checks, with the tolerances of `test_torch_train.py`'s
#: ``fit`` checks: the metrics of each step, the first step's gradients
#: relative to each tensor's largest, the running statistics and EMA, and
#: Adam's first steps, which move a weight by ~lr * sign(g), so a gradient
#: near zero whose sign differs in its last bits moves it by up to 2 lr a
#: step
METRIC_RTOL = 1e-4
GRAD_RTOL = 1e-4
STATS_TOL = dict(rtol=1e-3, atol=1e-5)
ADAM_ATOL = 2 * R.TCFG.initial_lr * R.STEPS
#: the float32 two-rank runs against one process, with the limits of the
#: card's float32 train step against the CPU's (`chip_smoke.py`, train
#: phase): losses relative, accuracies within one example, the first
#: step's gradients in L2 over all tensors and in each tensor of 128
#: entries or more; statistics and parameters as in float64
LOSS_RTOL = C.STEP_LOSS_RTOL
GRAD_L2_RTOL, GRAD_TENSOR_RTOL = C.STEP_GRAD_RTOL, C.STEP_TENSOR_RTOL
#: `test_torch_model.py`'s float32 limit for a tower's outputs
MODEL_ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


@pytest.mark.parametrize("world,data,model", [
    (1, None, 1), (2, None, 1), (2, None, 2), (8, None, 2), (8, None, 4),
    (8, None, 3), (8, 3, 2), (2, 2, 2)])
def test_mesh_coords_match_jax(world, data, model):
    """Each rank's ``(data, model)`` place is its device's place in JAX's
    mesh over the first ``world`` of the 8 virtual devices; a shape that
    is not the world raises the same error in both."""
    devices = jax.devices()[:world]
    try:
        want = JM.make_mesh(data, model, devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            M.mesh_coords(world, data, model)
        assert str(got.value) == str(e)
        return
    coords = M.mesh_coords(world, data, model)
    ids = [d.id for d in devices]
    for (d, m), dev in np.ndenumerate(want.devices):
        assert coords[ids.index(dev.id)] == (d, m)


def test_local_game_slice_matches_jax(monkeypatch):
    for n in range(1, 6):
        for i in range(n):
            monkeypatch.setattr(jax, "process_count", lambda n=n: n)
            monkeypatch.setattr(jax, "process_index", lambda i=i: i)
            for total in range(34):
                assert D.local_game_slice(total, i, n) == \
                    JD.local_game_slice(total)


@pytest.mark.parametrize("bank_games", [4, 0])
def test_example_rows_are_the_whole_batch_rows(bank_games):
    """``batches(n, rows=...)`` gives those rows of the batches drawn
    without ``rows`` from the same seed (banked, and replayed per batch),
    augmentation included."""
    with open(GAMES) as fh:
        lines = [line.strip() for line in fh if line.strip()]
    make = lambda: TPL.ExampleSource(  # noqa: E731
        lines, 8, seed=3, positions_per_game=4, bank_games=bank_games,
        use_native=False, device="cpu")
    rows = slice(4, 8)
    for (fw, lw), (fg, lg) in zip(make().batches(2),
                                  make().batches(2, rows=rows)):
        assert torch.equal(fg, fw[rows])
        for k, v in lw.items():
            assert torch.equal(lg[k], v[rows]), k


# ---------------------------------------------------------------------------
# the two-rank group


@functools.lru_cache(maxsize=None)
def _batches():
    """Three fixed augmented global batches of 16 (the port's banked
    source)."""
    with open(GAMES) as fh:
        lines = [line.strip() for line in fh if line.strip()]
    src = TPL.ExampleSource(lines, R.BATCH, seed=1, positions_per_game=4,
                            bank_games=4, use_native=False, device="cpu")
    return [(f, l) for f, l in src.batches(R.STEPS)]


def _jax_batch(batch):
    feats, labels = batch
    return jnp.asarray(feats.double().numpy()), {
        k: jnp.asarray(v.double().numpy()) for k, v in labels.items()}


class _JaxFixed:
    def batches(self, n):
        for batch in _batches()[:n]:
            yield _jax_batch(batch)


@functools.lru_cache(maxsize=None)
def _sd0():
    """The initial weights: the port's seeded train tower."""
    return R.trainer_from(
        TT.init_train_tower(R.MCFG, seed=0, device="cpu").state_dict()
    ).model.state_dict()


class _Background(threading.Thread):
    """``fn(*args)`` on a thread of its own; :meth:`result` joins it and
    raises what it raised."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self.fn, self.args, self.error = fn, args, None
        self.start()

    def run(self):
        try:
            self.fn(*self.args)
        except Exception as e:  # noqa: BLE001 (raised by result)
            self.error = e

    def result(self):
        self.join()
        if self.error:
            raise self.error


@functools.lru_cache(maxsize=None)
def _dryrun() -> _Background:
    """``dryrun_multichip(2, device="cpu")``, run while the other checks
    compute."""
    return _Background(tentry.dryrun_multichip, 2, "cpu")


@functools.lru_cache(maxsize=None)
def _group():
    """The two-rank group (`_mesh_ranks.run_rank`) and its directory,
    started with the dry run, both run while this process computes JAX's
    side."""
    _dryrun()
    tmp = tempfile.mkdtemp(prefix="mesh_ranks_")
    # copies: pickling a tensor for a spawned process moves its storage
    # into shared memory, which would race with this process's reads
    clone = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    args = (tmp, clone(_sd0()), [(f.clone(), clone(l)) for f, l in
                                 _batches()], B._W, B._PEAK)
    return _Background(D.spawn, R.run_rank, 2, args), tmp


@functools.lru_cache(maxsize=None)
def _ranks():
    """Both ranks' records and the checkpoint the group wrote."""
    group, tmp = _group()
    _jax_run()
    group.result()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
            for r in range(2)], os.path.join(tmp, "mesh_ckpt")


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's trainer under ``shard_over`` a ``data = 2`` mesh of two
    devices, computing in float64, from the port's initial weights
    carried across by ``to_train_tree``: the first step's gradients on
    the mesh, then three steps of ``fit``.  The ranks' group runs
    meanwhile."""
    _group()
    with jax.enable_x64():
        params, stats = TP.to_train_tree(R.MCFG, _sd0())
        params = jax.tree_util.tree_map(jnp.asarray, params)
        state = JTL.TrainState(
            params=params, opt_state=JTL.make_optimizer().init(params),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
            step=jnp.int32(0))
        trainer = JTL.Trainer(
            JMCFG, JTCFG, state,
            JLR.LearningRateScheduler(JTCFG.initial_lr, JTCFG.lr_decay),
            ema_params=jax.tree_util.tree_map(
                lambda p: jnp.copy(p.astype(jnp.float32)), state.params))
        stats0 = _np(state.batch_stats)
        trainer.shard_over(JM.make_mesh(data=2, devices=jax.devices()[:2]))
        feats, labels = trainer._place_batch(*_jax_batch(_batches()[0]))

        def loss_fn(p):
            out, _ = JT.apply_tower(JMCFG, p, trainer.state.batch_stats,
                                    feats, train=True)
            return JL.total_loss(out, labels, JTCFG)[0]

        grads = _np(jax.jit(jax.grad(loss_fn))(trainer.state.params))
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/metrics.jsonl"
            trainer.fit(_JaxFixed(), R.STEPS, metrics_path=path)
            with open(path) as fh:
                metrics = fh.read()
        sd = lambda p, s: TP.from_train_tree(R.MCFG, p, s)  # noqa: E731
        stats = _np(trainer.state.batch_stats)
        return {
            "grads": sd(grads, stats0), "metrics": metrics,
            "state": sd(_np(trainer.state.params), stats),
            "ema": {k: v for k, v in sd(_np(trainer.ema_params),
                                        stats).items()
                    if not k.endswith((".mean", ".var"))}}


@functools.lru_cache(maxsize=None)
def _one_process(dtype):
    """The same three steps in one process on the whole batches."""
    with tempfile.TemporaryDirectory() as tmp:
        return R.train_record(R.trainer_from(_sd0(), dtype),
                              R.in_dtype(_batches(), dtype),
                              f"{tmp}/metrics.jsonl")


def _metric_rows(text):
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("step", "time")} for line in text.splitlines()]


def _check_metrics(got, want, loss_rtol, other_atol=0.0, steps=R.STEPS):
    """The first ``steps`` steps' metrics: losses (all of them without
    ``other_atol``) within ``loss_rtol``, the others within
    ``other_atol``."""
    rows_got, rows_want = _metric_rows(got), _metric_rows(want)
    assert len(rows_got) == len(rows_want) == R.STEPS
    for mg, mw in list(zip(rows_got, rows_want))[:steps]:
        assert mg.keys() == mw.keys()
        for k, v in mw.items():
            if k.startswith("loss") or not other_atol:
                np.testing.assert_allclose(mg[k], v, rtol=loss_rtol,
                                           err_msg=k)
            else:
                assert abs(mg[k] - v) <= other_atol, (k, mg[k], v)


def _check_state(got, want, most_within=0.95):
    """Running statistics and EMA within ``STATS_TOL``, parameters after
    Adam within ``ADAM_ATOL``, and (with ``most_within``) more than that
    share of them within 1e-5."""
    moved = []
    for k, v in want["state"].items():
        a, b = got["state"][k].double().numpy(), v.double().numpy()
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(a, b, **STATS_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=ADAM_ATOL,
                                       err_msg=k)
            moved.append(np.mean(np.abs(a - b) <= 1e-5))
    assert not most_within or np.mean(moved) > most_within, moved
    for k, v in want["ema"].items():
        np.testing.assert_allclose(got["ema"][k].double().numpy(),
                                   v.double().numpy(), **STATS_TOL,
                                   err_msg=f"ema {k}")


def _check_exact(got, want):
    """``test_torch_train.py``'s ``fit`` checks, float64."""
    for k, g in got["grads"].items():
        w = want["grads"][k].double()
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.double().numpy(), w.numpy(),
                                   atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=f"gradient {k}")
    _check_metrics(got["metrics"], want["metrics"], METRIC_RTOL)
    _check_state(got, want)


def _ranks_agree(ranks, name):
    for key in ("state", "ema"):
        for k, v in ranks[0][name][key].items():
            assert torch.equal(v, ranks[1][name][key][k]), (name, key, k)


@pytest.mark.parametrize("model", [1, 2])
def test_mesh_train_steps_match_one_process(model):
    """Two ranks (data = 2, or model = 2 with the policy head split)
    against one process on the whole batches, in float64: the first
    step's gradients, three steps' metrics, the parameters after Adam, the
    running statistics (the global batch's) and the EMA; the ranks end
    equal."""
    ranks, _ = _ranks()
    _check_exact(ranks[0][f"float64_model{model}"],
                 _one_process(torch.float64))
    _ranks_agree(ranks, f"float64_model{model}")


@pytest.mark.parametrize("model", [1, 2])
def test_mesh_train_steps_match_jax_shard_over(model):
    """The same two-rank runs against JAX's ``Trainer`` under
    ``shard_over`` a ``data = 2`` mesh of two devices (float64 compute),
    its initial weights carried across by ``from_train_tree``."""
    ranks, _ = _ranks()
    _check_exact(ranks[0][f"float64_model{model}"], _jax_run())


@pytest.mark.parametrize("model", [1, 2])
def test_mesh_train_steps_float32(model):
    """In float32, two ranks against one process: the first step within
    the card's train-step limits, the state after three steps within
    the limits of float64 (later steps' losses drift apart by ~1e-4, and
    a fifth of the weights by more than 1e-5, as Adam moves weights whose
    gradients differ in sign by up to 2 lr a step); the ranks end
    equal."""
    ranks, _ = _ranks()
    got, want = ranks[0][f"float32_model{model}"], \
        _one_process(torch.float32)
    diff = {k: float((g - want["grads"][k]).norm())
            for k, g in got["grads"].items()}
    norm = {k: float(g.norm()) for k, g in want["grads"].items()}
    assert math.sqrt(sum(d * d for d in diff.values())
                     / sum(n * n for n in norm.values())) <= GRAD_L2_RTOL
    for k, d in diff.items():
        if got["grads"][k].numel() >= C.STEP_GRAD_MIN_NUMEL:
            assert d <= GRAD_TENSOR_RTOL * norm[k], k
    _check_metrics(got["metrics"], want["metrics"], LOSS_RTOL,
                   1.0 / R.BATCH + 1e-6, steps=1)
    _check_state(got, want, most_within=None)
    _ranks_agree(ranks, f"float32_model{model}")


def test_mesh_checkpoint_and_dump_restore_in_one_process():
    """A checkpoint written under model = 2 (its policy head, Adam moments
    and EMA split over two ranks) restores in one process with every
    tensor whole and dumps byte-equal to the mesh's dump; restored on the
    mesh again it splits the head once and dumps the same."""
    ranks, ckpt = _ranks()
    rec = ranks[0]
    trainer = TTL.Trainer.restore(ckpt, R.TCFG, "cpu")
    assert trainer.dump_json() == rec["dump"] == ranks[1]["dump"]
    assert rec["dump_after_restore"] == rec["dump"]
    assert rec["local_policy_rows"] == (181, 361 * R.SIZE["num_samples"])
    whole = trainer.optimizer.state_dict()["state"]
    names = [k for k, _ in trainer.model.named_parameters()]
    i = names.index("policy_linear.weight")
    assert whole[i]["exp_avg"].shape == (362, 722)
    assert trainer.ema["policy_linear.weight"].shape == (362, 722)
    assert trainer.step == R.STEPS


def _undated(lines):
    return [re.sub(r"DT\[[^\]]*\]", "", line) for line in lines]


def test_mesh_policy_play_equals_one_process():
    """Two ranks playing 3 + 2 of 5 games, each with its rows of the whole
    batch's draws, return the one-process lines, in order, on both ranks;
    the draws matter (another seed plays other games)."""
    ranks, _ = _ranks()
    want = _undated(R.policy_lines())
    assert _undated(ranks[0]["policy_lines"]) == want
    assert _undated(ranks[1]["policy_lines"]) == want
    assert len(want) == 5
    assert _undated(R.policy_lines(seed=6)) != want


def test_mesh_search_play_equals_one_process_and_jax():
    """Two ranks of search play with the peaked predictor, Dirichlet noise
    and temperature sampling on, return the one-process lines; with
    noise off and greedy moves, the two-rank lines are JAX's."""
    ranks, _ = _ranks()
    want = _undated(R.search_lines(B._W, B._PEAK))
    assert _undated(ranks[0]["search_lines"]) == want
    assert _undated(ranks[1]["search_lines"]) == want
    jax_lines = JPL.search_self_play(
        B.peaked_predictor_jax(), JSP(**R.JAX_SEARCH),
        JSC(num_rollout=8, dirichlet_noise=0.0, adaptive=False), seed=0,
        tree_reuse=False)
    assert len(jax_lines) == 3
    assert _undated(ranks[0]["jax_lines"]) == _undated(jax_lines)
    assert _undated(ranks[1]["jax_lines"]) == _undated(jax_lines)


def test_mesh_continuous_play_splits_the_games():
    """Continuous search play on two ranks: each keeps its share of the 3
    slots live until it has its share of the 4 games; both return all 4
    lines, rank 0's first."""
    ranks, _ = _ranks()
    lines = ranks[0]["continuous_lines"]
    assert lines == ranks[1]["continuous_lines"]
    assert len(lines) == 4 and all(l.startswith("(;GM[1]") for l in lines)


def test_dryrun_multichip_on_cpu():
    """``dryrun_multichip(2, device="cpu")`` (started with the group)."""
    _dryrun().result()


def test_spawn_kills_the_group_when_a_rank_fails():
    """A rank that raises fails the group at once: the other, blocked in
    a collective, is killed rather than waited for."""
    with pytest.raises(RuntimeError, match="a rank exited"):
        D.spawn(R.fail_on_rank_one, 2, (), timeout=60)


def test_mesh_needs_loop_and_a_card():
    with pytest.raises(SystemExit):
        tcli.main(["--mesh", "--self-play", "1", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            tcli.main(["--loop", "1", "--mesh", "--device", "cuda"])


def test_entry_matches_jax():
    """``entry()``'s 128 x 9 forward at B = 16, carrying JAX ``entry()``'s
    ``PRNGKey(0)`` parameters, on its zero input and on random planes."""
    fn, (x,) = tentry.entry(device="cpu")
    assert tuple(x.shape) == (16, 32, 19, 19)
    cfg = JMC()
    params, stats = jax.jit(lambda k: JT.init_tower(cfg, k))(
        jax.random.PRNGKey(0))
    fn.model.load_state_dict(TP.from_jax_params(
        ModelConfig(), _np(params), _np(stats)))
    def forward(x):
        out, _ = JT.apply_tower(cfg, params, stats, x)
        return out.policy_logits, out.value, out.ownership

    forward = jax.jit(forward)
    rng = np.random.default_rng(0)
    for planes in (np.zeros((16, 19, 19, 32), np.float32),
                   (rng.random((16, 19, 19, 32)) < 0.3).astype(np.float32)):
        logits, value, ownership = fn(
            torch.from_numpy(planes).permute(0, 3, 1, 2))
        for got, want in zip((logits, value, ownership),
                             forward(jnp.asarray(planes))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=MODEL_ATOL, rtol=0)
