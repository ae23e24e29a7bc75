"""Leela-zero distillation in the port against the JAX package: the LZ
weight file, the teacher's forward pass, the ``lz_history`` batches (their
augmentation fed JAX's draws), the distilled labels, train steps on them
and the CLI's ``--start --lz-weights``.  Both packages on the first eight
games of the rl20 run, B = 8, teachers of 8 filters."""

import contextlib
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (one torch thread)
from dream_go_tpu.models import leela_zero as JLZ
from dream_go_tpu.train import distill as JD
from dream_go_tpu.train import pipeline as JPL
from dream_go_torch import cli
from dream_go_torch.config import ModelConfig, TrainConfig
from dream_go_torch.models import leela_zero as TLZ
from dream_go_torch.train import distill as TD
from dream_go_torch.train import pipeline as TPL
from dream_go_torch.train.train_loop import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
GAMES = ROOT / "tests" / "fixtures" / "rl20_gen0000_first8.sgf"
#: the teacher in float32 on both sides: XLA's and torch's convolutions
#: and softmax sum in different orders
TEACHER_ATOL = 1e-5


def _lines():
    with open(GAMES) as fh:
        return [line.strip() for line in fh if line.strip()]


def _flat(w):
    """``(name, array)`` of every tensor of an LZ weights dict."""
    out = [("input", w["input"])]
    out += [(f"block{i}.{j}", c) for i, pair in enumerate(w["blocks"])
            for j, c in enumerate(pair)]
    out += [(k, w[k]) for k in ("policy_conv", "policy_fc", "value_conv",
                                "value_fc1", "value_fc2")]
    return [(f"{name}.{k}", np.asarray(v)) for name, p in out
            for k, v in sorted(p.items())]


def test_random_weights_equal_jax():
    got, want = TLZ.random_weights(8, 2, seed=3), JLZ.random_weights(8, 2, 3)
    assert (got["channels"], got["num_blocks"]) == (8, 2)
    for (n, a), (m, b) in zip(_flat(got), _flat(want)):
        assert n == m
        np.testing.assert_array_equal(a, b, n)


@pytest.mark.parametrize("gz", [False, True])
def test_lz_file_round_trip_matches_jax(tmp_path, gz):
    import gzip

    w = TLZ.random_weights(8, 2, seed=1)
    path, jpath = str(tmp_path / "lz.txt"), str(tmp_path / "jax.txt")
    TLZ.save_weights(w, path)
    JLZ.save_weights(JLZ.random_weights(8, 2, seed=1), jpath)
    with open(path) as ft, open(jpath) as fj:
        assert ft.read() == fj.read()
    if gz:
        with open(path, "rb") as fh, gzip.open(path + ".gz", "wb") as gh:
            gh.write(fh.read())
        path += ".gz"
    got, want = TLZ.load_weights(path), JLZ.load_weights(path)
    assert (got["channels"], got["num_blocks"]) == (8, 2)
    for (n, a), (m, b) in zip(_flat(got), _flat(want)):
        assert n == m and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, n)


def test_bad_version_raises(tmp_path):
    path = tmp_path / "lz.txt"
    path.write_text("3\n1 2\n")
    with pytest.raises(ValueError, match="version"):
        TLZ.load_weights(str(path))


def test_teacher_matches_jax_forward():
    w = TLZ.random_weights(8, 2, seed=4)
    x = np.random.default_rng(0).random((6, 19, 19, 18)).astype(np.float32)
    x = (x > 0.5).astype(np.float32)
    vj, pj = JLZ.forward(JLZ.random_weights(8, 2, 4), jnp.asarray(x))
    vt, pt = TLZ.teacher(w, "cpu")(torch.from_numpy(x))
    assert vt.shape == (6,) and pt.shape == (6, 362)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=TEACHER_ATOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=TEACHER_ATOL)
    np.testing.assert_allclose(pt.sum(-1).numpy(), 1.0, atol=1e-5)


def _sources(augment, seed=5):
    kw = dict(use_native=False, lz_history=True, positions_per_game=4,
              bank_games=16)
    js = JPL.ExampleSource(_lines(), 8, seed=seed, augment=augment, **kw)
    ts = TPL.ExampleSource(_lines(), 8, seed=seed, augment=False,
                           device="cpu", **kw)
    return js, ts


def test_lz_history_batches_match_jax():
    """``lz_history`` forces one position a game and no bank; the batch's
    planes, labels and leela-zero planes equal JAX's bit for bit."""
    js, ts = _sources(augment=False)
    assert (ts.positions_per_game, ts.bank_games) == (1, 0)
    for (fj, lj), (ft, lt) in zip(js.batches(2), ts.batches(2)):
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        assert set(lt) == set(lj) and "lz_features" in lt
        assert lt["lz_features"].shape == (8, 19, 19, 18)
        for k in lj:
            np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), k)


def test_lz_history_augmentation_matches_jax_draws():
    """JAX's first augmented batch against the port's batch augmented with
    the draws of JAX's key: ``lz_features`` takes the same symmetry."""
    js, ts = _sources(augment=True, seed=9)
    fj, lj = next(iter(js.batches(1)))
    ft, lt = next(iter(ts.batches(1)))
    _, sub = jax.random.split(jax.random.PRNGKey(9))
    k_sym, k_hist = jax.random.split(sub)
    sym = torch.tensor(np.asarray(jax.random.randint(k_sym, (8,), 0, 8)))
    u = torch.tensor(np.asarray(jax.random.uniform(k_hist, (8,))))
    assert len(set(sym.tolist())) > 1
    ft, lt = TPL._augment(ft, lt, None, "v1", sym, u)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for k in lj:
        np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), k)


def test_distilled_labels_match_jax():
    js, ts = _sources(augment=False, seed=2)
    w = TLZ.random_weights(8, 1, seed=6)
    jd = JD.DistillationSource(js, JLZ.random_weights(8, 1, 6))
    td = TD.DistillationSource(ts, w)
    (fj, lj), (ft, lt) = next(iter(jd.batches(1))), next(iter(td.batches(1)))
    assert set(lt) == set(lj) and "lz_features" not in lt
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for k in ("value", "policy"):
        np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), rtol=0,
                                   atol=TEACHER_ATOL, err_msg=k)
    for k in ("ownership", "has_ownership"):
        np.testing.assert_array_equal(lt[k].numpy(), np.asarray(lj[k]), k)
    assert float(lt["has_ownership"].abs().max()) == 0.0


def test_two_fit_steps_on_distilled_labels():
    _, ts = _sources(augment=True, seed=1)
    src = TD.DistillationSource(ts, TLZ.random_weights(8, 1, seed=0))
    trainer = Trainer.create(
        ModelConfig(num_channels=8, num_blocks=1, num_samples=2,
                    compute_dtype="float32"),
        TrainConfig(batch_size=8), seed=0, device="cpu")
    metrics = trainer.fit(src, num_steps=2, log_every=0)
    assert trainer.step == 2 and np.isfinite(metrics["loss"])


def test_cli_start_and_verify_with_lz_weights(tmp_path):
    """``--start`` on the rl20 games, then ``--verify`` (32 batches) on
    the same games cut after 40 moves, whose replays are short."""
    lz, ckpt = str(tmp_path / "lz.txt"), str(tmp_path / "ckpt")
    metrics, short = str(tmp_path / "m.jsonl"), tmp_path / "short.sgf"
    TLZ.save_weights(TLZ.random_weights(8, 1, seed=2), lz)
    nodes = [line.rstrip(")").split(";") for line in _lines()]
    short.write_text("".join(";".join(n[:42]) + ")\n" for n in nodes))
    size = ["--device", "cpu", "--num-channels", "8", "--num-blocks", "1",
            "--num-samples", "2", "--batch-size", "8", "--lz-weights", lz]
    assert cli.main(["--start", str(GAMES), "--steps", "2", "--checkpoint",
                     ckpt, "--metrics", metrics, *size]) == 0
    with open(metrics) as fh:
        records = [json.loads(line) for line in fh]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert Trainer.restore(ckpt, device="cpu").step == 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["--verify", str(short), "--checkpoint", ckpt,
                         *size]) == 0
    verified = json.loads(out.getvalue())
    assert verified["ownership_accuracy"] >= 0.0
    assert all(np.isfinite(v) for v in verified.values())
