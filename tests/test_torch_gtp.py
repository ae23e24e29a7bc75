"""GTP serving of the port against `dream_go_tpu.gtp`: coordinates, the
UNST-N test, the NaN predictor's trees, the greedy scorer, the time
settings, and the engine's answers to the same command scripts with the
same predictors and the Dirichlet noise off.

Tolerance: bit-exact everywhere (board states, tree statistics, scores
and every response line), as no bf16 tower runs on the CPU.  The
answers that name the engine (``name``, ``version``,
``gomill-describe_engine``) and ``gomill-cpu_time`` are the only lines
allowed to differ.  JAX's compiled searches are shared through
module-scoped engines; the greedy and final-score cases start late in the
games of ``tests/fixtures/sample_games.sgf``, except the capped rollout of
random mid-game boards.
"""

import functools
import io
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge as B
import chip_smoke as C
from dream_go_tpu.config import SearchConfig as JSC
from dream_go_tpu.go import benson as JBN
from dream_go_tpu.go import engine as JE
from dream_go_tpu.gtp import time_settings as JTS
from dream_go_tpu.gtp.engine import GtpEngine as JGtp
from dream_go_tpu.mcts import predictor as JP
from dream_go_tpu.mcts import search as JS
from dream_go_tpu.selfplay import greedy as JG
from dream_go_tpu.selfplay import replay as JR
from dream_go_tpu.utils import coords as JC
from dream_go_torch.config import SearchConfig as TSC
from dream_go_torch.go import benson as TBN
from dream_go_torch.gtp import GtpEngine as TGtp
from dream_go_torch.gtp import run_server
from dream_go_torch.gtp import time_settings as TTS
from dream_go_torch.gtp.ponder import PonderService
from dream_go_torch.mcts import predictor as TP
from dream_go_torch.mcts import search as TS
from dream_go_torch.selfplay import greedy as TG
from dream_go_torch.utils import coords as TC
from dream_go_torch.utils import sgf

REPO = pathlib.Path(__file__).resolve().parents[1]
GAMES = REPO / "tests" / "fixtures" / "sample_games.sgf"
D4 = JC.from_gtp("D4")
#: answers that name the engine or read a clock
OWN = ("name", "version", "gomill-describe_engine", "gomill-cpu_time")

#: `tests/test_gtp.py`'s command set, as one session
FAKE_SCRIPT = [
    "protocol_version", "7 name", "version", "gomill-describe_engine",
    "known_command genmove", "known_command frobnicate", "list_commands",
    "frobnicate", "boardsize 19", "boardsize 9",
    "clear_board", "play black q16", "showboard", "play white q16",
    "clear_board", "play black q16", "undo", "play white q16",
    "clear_board", "undo",
    "clear_board", "genmove black", "showboard", "gomill-explain_last_move",
    "clear_board", "reg_genmove black", "play black d4", "clear_board",
    "komi 6.5", "kgs-time_settings byoyomi 600 30 5",
    "time_left black 540 5", "time_settings 0 30 0", "komi 7.5",
    "gomill-cpu_time", "quit",
]


def ask(engine, line):
    return engine.handle(line)[0]


def run_script(engine, script):
    return [ask(engine, line) for line in script]


def assert_same_answers(script, got, want):
    assert len(got) == len(want) == len(script)
    for cmd, g, w in zip(script, got, want):
        if cmd.split()[-1] in OWN or cmd.split()[0] in OWN:
            assert g.startswith("=") and w.startswith("="), cmd
            continue
        assert g == w, (cmd, g, w)


#: the positions of the sample games the tests read
SAMPLE_TARGETS = (0, 5, 30, 40, 150, 300, 380, 600, 700)


@jax.jit
def _step_unless(states, mv, keep):
    stepped = jax.vmap(JE.step)(states, mv)
    return jax.tree_util.tree_map(
        lambda old, new: jnp.where(
            keep.reshape(keep.shape + (1,) * (old.ndim - 1)), old, new),
        states, stepped)


@functools.lru_cache(maxsize=None)
def _sample_replay():
    """The three sample games replayed once: their JAX states before each
    move of ``SAMPLE_TARGETS``."""
    games = [sgf.parse_line(line) for line in GAMES.read_text().splitlines()]
    states = JE.new_states(3).replace(
        komi=jnp.asarray([g.komi for g in games], jnp.float32))
    saved = {}
    for t in range(max(SAMPLE_TARGETS) + 1):
        if t in SAMPLE_TARGETS:
            saved[t] = states
        mv = np.asarray([g.moves[t].point if t < len(g.moves) else 361
                         for g in games], np.int32)
        states = _step_unless(states, jnp.asarray(mv),
                              jnp.asarray([t >= len(g.moves) for g in games]))
    return saved


def sample_states(targets):
    """JAX states of sample game ``g`` before move ``targets[g]``."""
    saved = _sample_replay()
    return jax.tree_util.tree_map(
        lambda *rows: jnp.stack(rows),
        *[jax.tree_util.tree_map(lambda x: x[g], saved[t])
          for g, t in enumerate(targets)])


def one(states, i):
    return jax.tree_util.tree_map(lambda x: x[i:i + 1], states)


@pytest.fixture(scope="module")
def jax_fake():
    return JGtp(JP.fake_predictor(D4, value=0.6), JSC(dirichlet_noise=0.0),
                num_rollout=8)


def torch_fake(**kw):
    return TGtp(TP.fake_predictor(D4, value=0.6), TSC(dirichlet_noise=0.0),
                num_rollout=8, device="cpu", **kw)


@pytest.fixture(scope="module")
def late_game(tmp_path_factory):
    """One line of sample_games.sgf in a file of its own, and the smoke's
    late move cap."""
    line = GAMES.read_text().splitlines()[2]
    path = tmp_path_factory.mktemp("gtp") / "game.sgf"
    path.write_text(line + "\n")
    return str(path), C.SERVE_REF_CAP


@pytest.fixture(scope="module")
def det_answers(late_game):
    """JAX's answers to the det script.  Its final_score and
    final_status_list roll the same position out; JAX traces and compiles
    the rollout's loop anew at every call, so the second call takes the
    first one's result (the rollout is a pure function of its inputs)."""
    import dream_go_tpu.gtp.engine as jax_gtp

    memo = {}

    def rollout(states, predictor, **kw):
        key = (np.asarray(states.stones).tobytes(),
               np.asarray(states.to_move).tobytes(), tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = JG.greedy_rollout(states, predictor, **kw)
        return memo[key]

    script = C.gtp_script(*late_game)
    eng = JGtp(B.det_predictor_jax(), JSC(dirichlet_noise=0.0),
               num_rollout=16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gtp, "greedy_rollout", rollout)
        answers = run_script(eng, script)
    assert len(memo) == 1
    return script, answers, eng


# ---------------------------------------------------------------------------
# coordinates, time settings


def test_coords_match_jax_on_every_point():
    for p in range(362):
        for enc in ("to_gtp", "to_sgf", "to_sabaki"):
            assert getattr(TC, enc)(p) == getattr(JC, enc)(p), (enc, p)
        assert TC.from_gtp(TC.to_gtp(p)) == JC.from_gtp(JC.to_gtp(p)) == p
        assert TC.from_sgf(TC.to_sgf(p)) == p
        assert TC.from_sabaki(TC.to_sabaki(p)) == JC.from_sabaki(
            JC.to_sabaki(p)) == p
        if p < 361:
            assert TC.point_xy(p) == JC.point_xy(p)
            assert TC.point(*TC.point_xy(p)) == p
    for s in ("pass", "PASS", "resign", "a1", "T19", "j10", "tt", ""):
        for dec in ("from_gtp", "from_sgf", "from_sabaki"):
            try:
                want = getattr(JC, dec)(s)
            except (ValueError, IndexError) as exc:
                with pytest.raises(type(exc)):
                    getattr(TC, dec)(s)
            else:
                assert getattr(TC, dec)(s) == want, (dec, s)


@pytest.mark.parametrize("kind,args", [
    ("absolute", (300.0,)), ("byo_yomi", (60.0, 10.0, 3)),
    ("canadian", (0.0, 30.0, 10)), ("canadian", (600.0, 30.0, 5)),
    ("none", ())])
def test_time_settings_match_jax(kind, args):
    """The copied regret-weighted budgets on `TestRegretBudget`'s cases,
    at every move number, with main time spent and periods left."""
    jt, tt = JTS.TimeSettings(), TTS.TimeSettings()
    for ts in (jt, tt):
        getattr(ts, f"set_{kind}")(*args)
    for mv in range(0, 300, 7):
        assert tt.budget(1, mv) == jt.budget(1, mv)
    for ts in (jt, tt):
        ts.time_left(2, 17.5, 2)
        ts.remaining[1] = 0.0
    for mv in (0, 100, 246, 247, 250):
        assert tt.budget(1, mv) == jt.budget(1, mv)
        assert tt.budget(2, mv) == jt.budget(2, mv)


# ---------------------------------------------------------------------------
# search readers and the NaN predictor


def test_search_unstable_matches_jax(det_answers):
    """On the trees of both packages (JAX's from the det engine's compiled
    genmove search, 16 rollouts), and again after the root edges' stats
    are replaced by numpy-drawn ones, so that both outcomes occur."""
    search = det_answers[2]._search_fn[(16, False, 17)]
    states = sample_states([40, 150, 300])
    rng = np.random.default_rng(5)
    n = rng.integers(0, 4, (3, 362)).astype(np.int32)
    n[0] = 0                                    # no visited child
    w = (rng.random((3, 362)) * n).astype(np.float32)
    w[1] = n[1] * 0.5                           # every q equal
    got, want = [], []
    for i in range(3):
        js = one(states, i)
        tj = search(js, jax.random.PRNGKey(0))
        tt = TS.search(B.to_torch(js), B.det_predictor_torch(),
                       torch.Generator().manual_seed(0),
                       TSC(dirichlet_noise=0.0), 16, capacity=17)
        np.testing.assert_array_equal(tt.root_edge_n.numpy(),
                                      np.asarray(tj.root_edge_n))
        want.append(np.asarray(jax.vmap(JS.search_unstable)(tj)))
        got.append(TS.search_unstable(tt).numpy())
        want.append(np.asarray(jax.vmap(JS.search_unstable)(tj.replace(
            root_edge_n=jnp.asarray(n[i:i + 1]),
            root_edge_w=jnp.asarray(w[i:i + 1])))))
        got.append(TS.search_unstable(tt.replace(
            root_edge_n=torch.from_numpy(n[i:i + 1]),
            root_edge_w=torch.from_numpy(w[i:i + 1]))).numpy())
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    assert np.concatenate(got).any() and not np.concatenate(got).all()


def test_nan_predictor_search_trees_match_jax():
    """All-NaN values and priors: the sane-value path (0.5) and uniform
    priors, in every tree field."""
    js = sample_states([0, 30, 5])
    cfg = JSC(dirichlet_noise=0.0)
    tj = jax.jit(lambda st: JS.search(st, JP.nan_predictor(),
                                      jax.random.PRNGKey(0), cfg, 6))(js)
    tt = TS.search(B.to_torch(js), TP.nan_predictor(),
                   torch.Generator().manual_seed(0),
                   TSC(dirichlet_noise=0.0), 6)
    for f in ("root_edge_n", "root_child", "slot_action", "slot_n",
              "node_n", "parent", "size", "root_edge_w", "slot_w",
              "node_w", "node_m2", "value0"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), f)
    np.testing.assert_array_equal(tt.prior.float().numpy(),
                                  np.asarray(tj.prior.astype(jnp.float32)))
    assert float(tt.value0[0, 0]) == 0.5


# ---------------------------------------------------------------------------
# greedy scoring


def test_greedy_rollout_and_scores_match_jax():
    """One batch: late positions of the three sample games, rolled out to
    scorable, and three random mid-game boards, stopped by the 30-move
    cap.  Equal final states, and the port's ``guess_score`` of the late
    boards (and ``greedy_score`` of the first) equal to JAX's
    ``guess_score`` of JAX's finished boards."""
    late = sample_states([600, 700, 380])
    mid = B.random_states(3, [60, 120, 200], 21)
    js = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                late, mid)
    fin_j = JG.greedy_rollout(js, B.det_predictor_jax(), max_moves=30)
    ts = B.to_torch(js)
    fin_t = TG.greedy_rollout(ts, B.det_predictor_torch(), max_moves=30)
    B.assert_states_equal(fin_t, fin_j)
    moved = np.asarray(fin_j.move_count) - np.asarray(js.move_count)
    assert (moved[:3] < 30).all() and (moved[3:] == 30).all()
    want = np.asarray(jax.vmap(JBN.guess_score)(
        fin_j.stones, fin_j.chain_id, js.komi))[:3]
    late_t = B.to_torch(late)
    np.testing.assert_array_equal(TBN.guess_score(
        fin_t.stones[:3], fin_t.chain_id[:3], late_t.komi).numpy(), want)
    np.testing.assert_array_equal(
        TG.greedy_score(late_t.index(slice(0, 1)),
                        B.det_predictor_torch()).numpy(), want[:1])


# ---------------------------------------------------------------------------
# the engine


def test_command_set_matches_jax_with_fake_predictor(jax_fake):
    want = run_script(jax_fake, FAKE_SCRIPT)
    eng = torch_fake()
    got = run_script(eng, FAKE_SCRIPT)
    assert_same_answers(FAKE_SCRIPT, got, want)
    assert got[1] == "=7 dream_go_torch\n"
    assert len(got[FAKE_SCRIPT.index("list_commands")].splitlines()) == 24
    assert got[FAKE_SCRIPT.index("genmove black")] == "= D4\n"
    assert "TPU" not in got[FAKE_SCRIPT.index("gomill-describe_engine")]
    assert not any(isinstance(k, tuple) and k[0] == "unst"
                   for k in eng._search_keys)


def test_command_script_matches_jax_with_det_predictor(det_answers):
    """The smoke's card-against-CPU session: genmoves, a cleanup genmove,
    reg_genmove, undo, loadsgf with a move cap, final_score and
    final_status_list."""
    script, want, _ = det_answers
    eng = TGtp(B.det_predictor_torch(), TSC(dirichlet_noise=0.0),
               num_rollout=16, device="cpu")
    got = run_script(eng, script)
    assert_same_answers(script, got, want)
    assert not any(a.startswith("?") for a in got)
    assert got[script.index("final_score")].startswith(("= B+", "= W+"))
    assert eng._search_keys == set(det_answers[2]._search_fn)


def test_quantized_sims_and_rate_ewma_match_jax(jax_fake):
    eng = torch_fake()
    for sims in (0, 15, 16, 17, 100, 399, 400, 1599, 1600, 5000, 10**6):
        assert eng._quantize_sims(sims) == jax_fake._quantize_sims(sims)
    jax_fake._sims_per_sec, jax_fake._warmed_keys = 500.0, set()
    calls = [((64, False, 65), 64, 2.0), ((64, False, 65), 64, 0.5),
             (("cont", 64), 64, 0.25), ((64, False, 65), 64, 0.0),
             (("cont", 64), 64, 1.0), ((64, False, 65), 64, 0.125)]
    for key, sims, secs in calls:
        eng._record_rate(key, sims, secs)
        jax_fake._record_rate(key, sims, secs)
        assert eng._sims_per_sec == jax_fake._sims_per_sec
    assert eng._sims_per_sec != 500.0
    for kind, args in (("set_byo_yomi", (30.0, 5.0, 1)),
                       ("set_absolute", (1.0,))):
        for e in (eng, jax_fake):
            getattr(e.time_settings, kind)(*args)
        for color in (1, 2):
            assert eng._sims_for_budget(color) == \
                jax_fake._sims_for_budget(color)
    for e in (eng, jax_fake):
        e.time_settings.set_none()


def test_timed_genmove_extends():
    """A timed genmove reserves the UNST-N head-room and, on an unstable
    root, searches on: an extension key and more visits than the budget."""
    eng = TGtp(B.det_predictor_torch(), TSC(dirichlet_noise=0.0),
               num_rollout=24, device="cpu")
    assert ask(eng, "time_settings 120 0 0") == "=\n"
    extended = []
    orig = eng._maybe_extend

    def spy(trees, color, sims, cleanup):
        out = orig(trees, color, sims, cleanup)
        extended.append(int(TS.root_visits(out).sum()) - sims)
        return out

    eng._maybe_extend = spy
    for mv in ("b", "w"):
        assert ask(eng, f"genmove {mv}").startswith("= ")
    assert any(isinstance(k, tuple) and len(k) == 3 and k[2] > 25
               for k in eng._search_keys)
    assert any(k[0] == "unst" for k in eng._search_keys), extended
    assert max(extended) >= 16


def test_ponder_accumulates_and_is_consumed(jax_fake):
    """The pondered tree is taken (its root has more visits than the
    budget) and gives JAX's answer."""
    want = run_script(jax_fake, ["clear_board", "play black q16",
                                 "genmove white"])
    eng = torch_fake(ponder=True)
    assert ask(eng, "play black q16") == "=\n"
    time.sleep(1.0)
    taken = []
    orig = eng.ponder.take
    eng.ponder.take = lambda st: taken.append(orig(st)) or taken[-1]
    assert ask(eng, "genmove white") == want[-1] == "= D4\n"
    assert taken[0] is not None and int(taken[0].node_n[0, 0]) > 8 + 1
    assert ("cont", 8) in eng._search_keys
    assert eng.ponder.last_wait < 30.0
    eng.ponder.stop()


def test_ponder_discards_on_mismatch():
    from dream_go_torch.go import engine as TE

    svc = PonderService(TP.fake_predictor(D4), TSC(dirichlet_noise=0.0),
                        chunk=4, capacity=64)
    s0 = TE.new_states(1, device="cpu")
    svc.start(s0)
    time.sleep(0.5)
    other = TE.step(s0, torch.tensor([TC.from_gtp("Q16")], dtype=torch.int32))
    assert svc.take(other) is None
    svc.start(s0)
    time.sleep(0.5)
    trees = svc.take(s0)
    assert trees is not None and int(trees.node_n[0, 0]) > 1


def test_server_stops_at_quit():
    out = io.StringIO()
    run_server(torch_fake(), infile=io.StringIO(
        "name\nversion\n# a comment\nquit\nplay black a1\n"), outfile=out)
    lines = [line for line in out.getvalue().splitlines() if line]
    assert lines == ["= dream_go_torch", "= 0.1.0", "="]


# ---------------------------------------------------------------------------
# the CLI as a subprocess, as `tests/test_sanity_gtp.py` drives JAX's


@pytest.fixture(scope="module")
def gtp_process(tmp_path_factory):
    """``python -m dream_go_torch.cli --gtp --device cpu`` with a stand-in
    ``jax`` package first on the path, which raises if imported."""
    fake = tmp_path_factory.mktemp("nojax")
    (fake / "jax").mkdir()
    (fake / "jax" / "__init__.py").write_text(
        "raise ImportError('the port imported jax')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(fake)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "dream_go_torch.cli", "--gtp", "--device",
         "cpu", "--num-channels", "8", "--num-blocks", "1",
         "--num-samples", "2", "--num-rollout", "8"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=REPO)

    def gtp(cmd):
        proc.stdin.write(cmd + "\n")
        proc.stdin.flush()
        out = []
        while True:
            line = proc.stdout.readline()
            if line.strip() == "" and out:
                break
            if line == "":
                raise RuntimeError("engine died")
            out.append(line.rstrip("\n"))
        return "\n".join(out)

    yield gtp
    try:
        proc.stdin.write("quit\n")
        proc.stdin.flush()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_gtp_identifies_itself(gtp_process):
    assert gtp_process("name") == "= dream_go_torch"
    assert gtp_process("protocol_version") == "= 2"


def test_cli_gtp_plays_a_legal_opening(gtp_process):
    assert gtp_process("clear_board").startswith("=")
    assert gtp_process("komi 7.5").startswith("=")
    for color in ("black", "white"):
        resp = gtp_process(f"genmove {color}")
        assert resp.startswith("= ")
        vertex = resp[2:]
        assert vertex == "pass" or (vertex[0] in "ABCDEFGHJKLMNOPQRST"
                                    and 1 <= int(vertex[1:]) <= 19)


def test_cli_gtp_rejects_occupied_point(gtp_process):
    gtp_process("clear_board")
    assert gtp_process("play black d4").startswith("=")
    assert gtp_process("play white d4").startswith("?")


def test_cli_gtp_final_score_formats(gtp_process, late_game):
    path, _ = late_game
    assert gtp_process(f"loadsgf {path} 400") == "="
    resp = gtp_process("final_score")
    assert resp.startswith("= ") and resp[2] in "BW0"
