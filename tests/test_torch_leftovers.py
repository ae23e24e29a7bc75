"""Small parts of the port against the JAX package: ``Config.from_env``
with ``DG_OPTS``/``DG_*`` overrides, ``SearchConfig.max_nodes`` and the
self-play tree capacity it sets, and the training heat map (its image, and
the PNG that the standard library writes)."""

import io

import numpy as np
import pytest
import torch

import _torch_bridge as B
from dream_go_tpu import config as JC
from dream_go_tpu.train import heatmap as JH
from dream_go_torch import config as TC
from dream_go_torch.selfplay import search_play as TPL
from dream_go_torch.train import heatmap as TH

#: the fields of the JAX package's ``from_env`` that the port has
SEARCH_FIELDS = ("num_rollout", "uct_exp", "fpu_reduce", "critical_value",
                 "dirichlet_noise", "temperature")
ENVS = [
    {},
    {"DG_NUM_ROLLOUT": "400", "DG_UCT_EXP": "10=2.0,100=1.5",
     "DG_NUM_GAMES": "64"},
    {"DG_OPTS": "num_rollout=800; temperature=0.25;fpu_reduce=0.3",
     "DG_DIRICHLET_NOISE": "0.1"},
    # a DG_<NAME> variable wins over DG_OPTS
    {"DG_OPTS": "NUM_ROLLOUT=100;critical_value=1=0.5,50=1.0",
     "DG_NUM_ROLLOUT": "250"},
]


@pytest.mark.parametrize("env", ENVS)
def test_from_env_matches_jax(env, monkeypatch):
    for name in ("DG_OPTS", "DG_NUM_ROLLOUT", "DG_UCT_EXP", "DG_NUM_GAMES",
                 "DG_DIRICHLET_NOISE", "DG_TEMPERATURE", "DG_FPU_REDUCE",
                 "DG_CRITICAL_VALUE"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = TC.Config.from_env(), JC.Config.from_env()
    for f in SEARCH_FIELDS:
        a, b = getattr(got.search, f), getattr(want.search, f)
        if isinstance(b, JC.Schedule):
            assert a.knots == b.knots, f
        else:
            assert a == b and type(a) is type(b), f
    for f in ("num_games", "num_rollout"):
        assert getattr(got.self_play, f) == getattr(want.self_play, f), f
    assert got.model == TC.ModelConfig() and got.train == TC.TrainConfig()
    if env:
        assert got != TC.Config()


def test_env_override_types(monkeypatch):
    monkeypatch.setenv("DG_FLAG", "yes")
    monkeypatch.setenv("DG_OPTS", "count=7;ratio=0.5")
    for name, default in (("FLAG", False), ("COUNT", 1), ("RATIO", 1.0),
                          ("ABSENT", 3)):
        got = TC._env_override(name, default)
        assert got == JC._env_override(name, default)
        assert type(got) is type(default)


@pytest.mark.parametrize("kw", [dict(), dict(max_nodes=50),
                                dict(num_rollout=100),
                                dict(num_rollout=100, max_nodes=7)])
def test_max_nodes_matches_jax(kw):
    t, j = TC.SearchConfig(**kw), JC.SearchConfig(**kw)
    assert t.max_nodes == j.max_nodes
    assert t.resolved_max_nodes() == j.resolved_max_nodes()


@pytest.mark.parametrize("max_nodes,reuse,want",
                         [(0, True, 12), (0, False, 5), (40, True, 40),
                          (40, False, 40)])
def test_search_self_play_capacity(max_nodes, reuse, want):
    """The capacity rule of `search_play.py:74-81`: ``max_nodes`` wins over
    ``num_sims + 8`` (reuse) and ``num_sims + 1`` (fresh trees)."""
    cfg = TC.SearchConfig(num_rollout=4, max_nodes=max_nodes, fused=False,
                          adaptive=False, dirichlet_noise=0.0)
    first, _ = TPL._build_search_move_fn(B.det_predictor_torch(), cfg, 4, 0,
                                         tree_reuse=reuse)
    states = TPL.engine.new_states(2, device="cpu")
    budget = torch.full((2,), 4, dtype=torch.int32)
    _, trees, *_ = first(states, torch.Generator().manual_seed(0), budget)
    assert trees.node_n.shape[1] == want


def _board():
    rng = np.random.default_rng(0)
    stones = rng.choice([0, 0, 1, 2], 361)
    heat = rng.uniform(-1.2, 1.2, 361).astype(np.float32)
    heat[::7] = 0.0
    return stones, heat


@pytest.mark.parametrize("with_heat", [False, True])
def test_heat_image_matches_jax(with_heat):
    stones, heat = _board()
    heat = heat if with_heat else None
    got, want = TH.heat_image(stones, heat), JH.heat_image(stones, heat)
    assert got.dtype == np.uint8 and got.shape == (304, 304, 3)
    np.testing.assert_array_equal(got, want)


def test_save_heat_image_writes_the_png(tmp_path):
    from PIL import Image

    stones, heat = _board()
    path = tmp_path / "heat.png"
    TH.save_heat_image(str(path), stones, heat)
    with Image.open(io.BytesIO(path.read_bytes())) as img:
        assert img.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(img),
                                      JH.heat_image(stones, heat))
