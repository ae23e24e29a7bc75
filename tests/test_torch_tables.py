"""Port tables, constants and configuration against the JAX package."""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_go_tpu import config as jcfg
from dream_go_tpu.go import topology as jtop
from dream_go_tpu.go import zobrist as jz
from dream_go_tpu.ops import env_step as jes
from dream_go_torch import config as tcfg
from dream_go_torch.go import topology as ttop
from dream_go_torch.go import zobrist as tz
from dream_go_torch.ops import layout as tl


@pytest.mark.parametrize("name", ["NBR", "NBR8", "IOTA", "SYM", "SYM_INV",
                                  "SYM_POLICY", "SYM_POLICY_INV"])
def test_topology_table_matches(name):
    np.testing.assert_array_equal(getattr(ttop, name), getattr(jtop, name))


def test_zobrist_table_matches():
    np.testing.assert_array_equal(tz.Z, jz.Z)
    np.testing.assert_array_equal(tz.Z_I32.view(np.uint32), jz.Z)


def test_layout_constants_match():
    assert (tl.NP, tl.RING) == (jes.NP, jes.RING)
    np.testing.assert_array_equal(tl.VALID, jes._VALID)
    assert tl.SHIFTS == jes._SHIFTS
    for s in tl.SHIFTS:
        np.testing.assert_array_equal(tl.MASK[s], jes._MASK[s])


@pytest.mark.parametrize("text", ["44=1.87,2536=1.48", "44=0.67,3817=0.46",
                                  "1=0.0,44=1.49,200=2.12", "0.5"])
def test_schedule_at_matches_jnp_interp(text):
    visits = np.array([0, 1, 2, 43, 44, 45, 100, 199, 200, 201, 1000, 2536,
                       3000, 3817, 5000], np.float32)
    want = np.asarray(jcfg.Schedule.parse(text).at(jnp.asarray(visits)))
    got = tcfg.Schedule.parse(text).at(torch.from_numpy(visits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tcfg.Schedule.parse(text).at_host(100.0) == \
        jcfg.Schedule.parse(text).at_host(100.0)


@pytest.mark.parametrize("cls", ["SearchConfig", "SelfPlayConfig",
                                 "ModelConfig", "TrainConfig"])
def test_config_defaults_match(cls):
    t, j = getattr(tcfg, cls)(), getattr(jcfg, cls)()
    names = {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(j):
        if f.name in names:
            want = getattr(j, f.name)
            want = getattr(want, "knots", want)
            assert getattr(getattr(t, f.name), "knots",
                           getattr(t, f.name)) == want, f.name


def test_resolve_auto_follows_device():
    cfg = tcfg.SearchConfig()
    assert cfg.resolve_auto("cuda").fused is True
    assert cfg.resolve_auto("cuda").adaptive is True
    assert cfg.resolve_auto("cpu").fused is False
    off = tcfg.SearchConfig(fused=False, adaptive=False)
    assert off.resolve_auto("cuda").fused is False
    assert off.resolve_auto("cuda").adaptive is False


def test_port_imports_neither_jax_nor_the_jax_package():
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "dream_go_torch").rglob("*.py")) + \
        [root / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "orbax", "dream_go_tpu"), (path, m)


@pytest.mark.parametrize("cls,fields", [
    ("TrainConfig", [f.name for f in dataclasses.fields(jcfg.TrainConfig)]),
    ("ModelConfig", ["num_features", "feature_set", "remat"]),
    ("SearchConfig", ["feature_set"]),
    ("SearchConfig", ["max_nodes"]),
    ("SelfPlayConfig", ["ex_it", "ex_it_fraction", "ladder_features"])])
def test_config_fields_present(cls, fields):
    """The trainer slice's fields exist in the port with JAX's defaults
    (``test_config_defaults_match`` compares the fields both have)."""
    t, j = getattr(tcfg, cls)(), getattr(jcfg, cls)()
    for name in fields:
        assert getattr(t, name) == getattr(j, name), name
