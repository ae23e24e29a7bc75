"""Port tower, weights loading and predictor against the JAX package."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_go_tpu.config import ModelConfig as JMC
from dream_go_tpu.mcts import predictor as JP
from dream_go_tpu.models import params as JMP
from dream_go_tpu.models import tower as JT
from dream_go_torch.config import ModelConfig as TMC
from dream_go_torch.mcts import predictor as TP
from dream_go_torch.models import params as TMP
from dream_go_torch.models import tower as TT

torch.set_num_threads(1)  # see tests/_torch_bridge.py

#: fp32 on both sides; the two frameworks sum the convolutions in another
#: order (and the port folds BN into the kernels), so outputs agree to a
#: few float32 ulps of the logits' magnitude, not bit for bit
ATOL = 1e-4


def _features(batch, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((batch, 19, 19, 32)) < 0.3).astype(np.float32)
    x[..., 0] = rng.random()
    return x


def _perturb_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return rng.normal(0, 0.2, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, stats)


def test_tower_matches_apply_tower_fp32():
    jcfg = JMC(num_channels=32, num_blocks=3, compute_dtype="float32")
    params, stats = JT.init_tower(jcfg, jax.random.PRNGKey(1))
    stats = _perturb_stats(stats, 2)
    params = jax.tree_util.tree_map(np.asarray, params)
    x = _features(6, 3)
    want, _ = JT.apply_tower(jcfg, params, stats, jnp.asarray(x))

    tcfg = TMC(num_channels=32, num_blocks=3, compute_dtype="float32")
    sd = TMP.from_jax_params(tcfg, params, stats)
    model = TT.from_state_dict(tcfg, sd, device="cpu")
    logits, value, ownership = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want.policy_logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(value.detach().numpy(),
                               np.asarray(want.value), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ownership.detach().numpy(),
                               np.asarray(want.ownership), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(
        logits.detach().numpy().argmax(-1),
        np.asarray(want.policy_logits).argmax(-1))


def test_load_json_weights_match_jax():
    """``models/rl20/weights_0013.json`` through both loaders: identical
    parameters, and fp32 predictions within ATOL with equal argmax."""
    with open("models/rl20/weights_0013.json") as fh:
        text = fh.read()
    jcfg, jparams = JMP.load_json(text)
    tcfg, tparams = TMP.load_json(text)
    assert (tcfg.num_channels, tcfg.num_blocks, tcfg.num_samples,
            tcfg.ladder_features) == (jcfg.num_channels, jcfg.num_blocks,
                                      jcfg.num_samples, jcfg.ladder_features)
    jl, tl_ = jax.tree_util.tree_leaves_with_path(jparams), \
        jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in jl] == [p for p, _ in tl_]
    for (_, a), (_, b) in zip(jl, tl_):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))

    x = _features(4, 5)
    jcfg32 = JMC(num_channels=jcfg.num_channels, num_blocks=jcfg.num_blocks,
                 num_samples=jcfg.num_samples, compute_dtype="float32")
    jpred = JP.net_predictor(jcfg32, jax.tree_util.tree_map(
        jnp.asarray, jparams), folded=True)
    jv, jpol = jpred(jnp.asarray(x))
    model = TT.from_state_dict(tcfg, TMP.to_state_dict(tcfg, tparams),
                               device="cpu", dtype="float32")
    tpred = TP.net_predictor(model)
    tv, tpol = tpred(torch.from_numpy(x))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpol.numpy(), np.asarray(jpol), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tpol.numpy().argmax(-1),
                                  np.asarray(jpol).argmax(-1))
    # the plane-major entry point is the same function
    tv2, tpol2 = tpred.planes(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(tv2, tv) and torch.equal(tpol2, tpol)


def test_decode_entry_matches():
    with open("tests/fixtures/sanity_net.json") as fh:
        import json
        raw = json.load(fh)
    for name in list(raw)[:12]:
        np.testing.assert_array_equal(TMP.decode_entry(raw[name]),
                                      JMP.decode_entry(raw[name]))


@pytest.mark.parametrize("name", ["fake", "random"])
def test_simple_predictors_match(name):
    x = _features(3, 7)
    if name == "fake":
        jv, jp = JP.fake_predictor(17, 0.3)(jnp.asarray(x))
        tv, tp = TP.fake_predictor(17, 0.3)(torch.from_numpy(x))
    else:
        jv, jp = JP.random_predictor()(jnp.asarray(x))
        tv, tp = TP.random_predictor()(torch.from_numpy(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_init_tower_is_seeded():
    cfg = TMC(num_channels=16, num_blocks=2, compute_dtype="float32")
    a = TT.init_tower(cfg, seed=3, device="cpu").state_dict()
    b = TT.init_tower(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["value_linear.bias"][0]) == pytest.approx(-0.00502319782)


#: (fixture, moves replayed, colour to move): the sanity-test ladder
#: positions (tests/test_sanity_positions.py LADDER_CASES)
LADDER_POSITIONS = [("ladder_1", 70, 1), ("ladder_2", 18, 1),
                    ("ladder_3", 54, 2)]


def _ladder_positions():
    """The three positions replayed by both packages' engines from the
    SGF files, parsed by each package's own reader."""
    from dream_go_tpu.go import engine as jeng
    from dream_go_tpu.utils import sgf as jsgf
    from dream_go_torch.go import engine as teng
    from dream_go_torch.utils import sgf as tsgf

    jstep = jax.jit(jeng.step)
    jstates, tstates = [], []
    for name, limit, color in LADDER_POSITIONS:
        with open(f"tests/fixtures/sanity/{name}.sgf") as fh:
            line = fh.read().replace("\n", "")
        jg, tg = jsgf.parse_line(line), tsgf.parse_line(line)
        js = jeng.new_state(jg.komi)
        ts = teng.new_states(1, komi=tg.komi, device="cpu")
        for mv in jg.moves[:limit]:
            js = jstep(js.replace(to_move=jnp.int8(mv.color)),
                       jnp.int32(mv.point))
        for mv in tg.moves[:limit]:
            ts = teng.step(ts.replace(to_move=torch.tensor(
                [mv.color], dtype=torch.int8)), torch.tensor([mv.point]))
        jstates.append(js.replace(to_move=jnp.int8(color)))
        tstates.append(ts.replace(to_move=torch.tensor([color],
                                                       dtype=torch.int8)))
    jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *jstates)
    tb = teng.GoState(**{k: torch.cat([getattr(s, k) for s in tstates])
                         for k in tstates[0].fields()})
    return jb, tb


def test_sanity_net_root_eval_with_ladder_planes_matches_jax():
    """``tests/fixtures/sanity_net.json`` (64 x 6, its contract has planes
    30/31) evaluates the three ladder positions: equal planes (exact
    reader), float32 outputs within ATOL and the same argmax."""
    import _torch_bridge as B
    from dream_go_tpu.go import features as JF
    from dream_go_torch.go import features as TF

    with open("tests/fixtures/sanity_net.json") as fh:
        text = fh.read()
    jcfg, jparams = JMP.load_json(text)
    tcfg, tparams = TMP.load_json(text)
    assert jcfg.ladder_features and tcfg.ladder_features
    jb, tb = _ladder_positions()
    B.assert_states_equal(tb, jb)
    jx = jax.jit(functools.partial(
        JF.extract_batch, feature_set="v1", with_ladders=True,
        use_kernel=False, ladders_exact=True))(jb)
    tx = TF.extract_batch(tb, True, False, True)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert tx[..., 30:].sum() > 0

    jcfg32 = JMC(num_channels=jcfg.num_channels, num_blocks=jcfg.num_blocks,
                 num_samples=jcfg.num_samples, ladder_features=True,
                 compute_dtype="float32")
    jv, jpol = JP.net_predictor(jcfg32, jax.tree_util.tree_map(
        jnp.asarray, jparams), folded=True)(jx)
    model = TT.from_state_dict(tcfg, TMP.to_state_dict(tcfg, tparams),
                               device="cpu", dtype="float32")
    tv, tpol = TP.net_predictor(model)(tx)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tpol.numpy(), np.asarray(jpol), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(tpol.numpy().argmax(-1),
                                  np.asarray(jpol).argmax(-1))
