"""The port's CUDA kernels on the card, against their plain versions.

This module imports no JAX (the machine with the card has none), so it
runs there without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test skips.
"""

import pytest
import torch

from dream_go_torch.go import engine
from dream_go_torch.go.boards import (ENV_CASES, KO_ACTION, KO_MOVES,
                                      KO_RECAPTURE, LEAF_CASES, LEAF_KO,
                                      env_cases, env_step_cases, ko_captured,
                                      leaf_cases)
from dream_go_torch.ops import layout
from dream_go_torch.ops import leaf_step as L


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _boards(n, dev, seed):
    """Boards from random legal play of 0..250 moves; board 0 holds a ko
    capture and, where the batch has them, board 1 a finished game and
    board 2 a pass action."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    states = engine.new_states(n, device=dev)
    target = torch.linspace(0, 250, n, device=dev).long()
    target[0] = len(KO_MOVES)
    for i in range(int(target.max())):
        legal = engine.legal_mask(states)[:, :361]
        w = torch.where(legal.any(1, keepdim=True), legal.float(), 1.0)
        act = torch.multinomial(w, 1, generator=gen)[:, 0]
        act = torch.where(legal.any(1), act, 361)
        if i < len(KO_MOVES):
            act[0] = KO_MOVES[i]
        stepped = engine.step(states, act.to(torch.int32))
        states = states.select(i >= target, stepped)
    states.done[1:2] = True
    legal = engine.legal_mask(states)
    action = torch.multinomial(legal.float(), 1, generator=gen)[:, 0]
    action[0] = KO_ACTION
    action[2:3] = 361
    return states, action.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 256, 1024])
def test_leaf_step_kernel_matches_plain(cuda_device, batch):
    states, action = _boards(batch, cuda_device, seed=batch)
    args = list(layout.pack_states(states))
    before = L.launches
    got = L.leaf_step(*args, action, states.komi)
    torch.cuda.synchronize()
    assert L.launches == before + 1
    want = L.leaf_step_plain(*args, action, states.komi)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    if batch > 1:
        assert float(got[1][0, 29, KO_RECAPTURE]) == 1.0   # the ko


def _cat(parts):
    return engine.GoState(**{k: torch.cat([getattr(s, k) for s in parts])
                             for k in parts[0].fields()})


def _leaf_equal(fn, states, action):
    args = list(layout.pack_states(states))
    got = fn(*args, action, states.komi)
    torch.cuda.synchronize()   # a trap in the checked build raises here
    want = L.leaf_step_plain(*args, action, states.komi)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 256, 1024])
def test_leaf_step_kernel_on_scripted_boards(cuda_device, batch):
    """The boards that reach the kernel's counting paths (three chains
    merged, two captured at once, set unions, a super-ko found in a
    wrapped ring, a chain captured through two of its stones): each alone
    at B=1, else ahead of random boards."""
    cases, cact = leaf_cases(cuda_device)
    if batch == 1:
        outs = [_leaf_equal(L.leaf_step, cases.index(
            torch.tensor([i], device=cuda_device)), cact[i:i + 1])
            for i in range(cases.batch)]
        feats = torch.cat([o[1] for o in outs])
        cand = torch.cat([o[2] for o in outs])
    else:
        rand, ract = _boards(batch - cases.batch, cuda_device,
                             seed=batch + 4)
        _, feats, cand = _leaf_equal(L.leaf_step, _cat([cases, rand]),
                                     torch.cat([cact, ract]))
    names = [c[0] for c in LEAF_CASES]
    assert int(cases.placed_count[names.index("wrapped ko")]) > 64
    for name, point in LEAF_KO.items():   # the super-ko points
        assert float(feats[names.index(name), 29, point]) == 1.0
        assert not bool(cand[names.index(name), point])


@pytest.mark.cuda
def test_leaf_step_checked_build_matches_plain(cuda_device):
    """The bounds-checked build (-DDG_CHECK) traps on no board and steps as
    the plain version: the scripted boards and random ones, 1024 in all."""
    cases, cact = leaf_cases(cuda_device)
    rand, ract = _boards(1024 - cases.batch, cuda_device, seed=13)
    _leaf_equal(L.leaf_step_checked, _cat([cases, rand]),
                torch.cat([cact, ract]))


@pytest.mark.cuda
def test_leaf_step_kernel_rejects_bad_inputs(cuda_device):
    states, action = _boards(2, cuda_device, seed=0)
    args = list(layout.pack_states(states))
    with pytest.raises(TypeError):
        L.leaf_step(*args, action.long(), states.komi)
    with pytest.raises(ValueError):
        L.leaf_step(*args, action.cpu(), states.komi)
    bad = list(args)
    bad[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        L.leaf_step(*bad, action, states.komi)


# ---------------------------------------------------------------------------
# ladder planes (K2) and the liberties-after feature kernel (K3)

from dream_go_torch.go import boards  # noqa: E402
from dream_go_torch.ops import ladder_kernel as LK  # noqa: E402
from dream_go_torch.ops import libs_after as LA  # noqa: E402

PT = lambda r, c: 19 * r + c


def _curated(dev):
    """The ladder stress boards (black to move): the 31-rung staircase, a
    broken staircase, the 48-capture and the 12-escape swarms; then the
    two boards whose chases capture a third chain mid-ladder."""
    return boards.from_stones(boards.ladder_stress() + boards.ladder_capture(),
                              dev)


def _ladder_args(states):
    rows = layout.pack_states(states)
    return rows[0], rows[1], states.to_move.to(torch.int32).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 256])
def test_ladder_kernel_matches_plain(cuda_device, batch):
    states, _ = _boards(batch, cuda_device, seed=batch + 1)
    before = LK.launches
    got = LK.ladder_planes_kernel(*_ladder_args(states))
    torch.cuda.synchronize()
    assert LK.launches == before + 1
    want = LK.ladder_planes_plain(*_ladder_args(states))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ladder_kernel_on_stress_boards(cuda_device):
    states = _curated(cuda_device)
    cap, esc = LK.ladder_planes_kernel(*_ladder_args(states))
    want = LK.ladder_planes_plain(*_ladder_args(states))
    assert torch.equal(cap, want[0]) and torch.equal(esc, want[1])
    assert bool(cap[0, PT(3, 2)]) and not bool(cap[0, PT(2, 3)])
    assert not bool(cap[1, PT(3, 2)])
    assert int(cap[2].sum()) > 0 and int(esc[3].sum()) == 12
    # the chase that captures the stone at (6, 9) on its way still wins;
    # the escape whose counter-ladder captures fails, the unit's holds
    assert bool(cap[4, PT(3, 2)]) and bool(cap[4, PT(7, 9)])
    assert esc[5].nonzero()[:, 0].tolist() == [PT(15, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("budget,stack_cap,hit", [
    (320, 0, False), (320, 1, True), (320, 8, True), (24, 8, False),
    (61, 8, False), (62, 8, True)])
def test_ladder_kernel_staircase_bounds(cuda_device, budget, stack_cap, hit):
    """The stress and capture boards at a cut stack or budget: the kernel
    keeps the plain version's fail-safe answer; the staircase (31 rungs, 62
    with the alternates read) loses its capture with too few rungs or no
    stack."""
    states = _curated(cuda_device)
    got = LK.ladder_planes_kernel(*_ladder_args(states), budget, stack_cap)
    want = LK.ladder_planes_plain(*_ladder_args(states), budget, stack_cap)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[0][0, PT(3, 2)]) == hit


@pytest.mark.cuda
@pytest.mark.parametrize("stack_cap", [1, 8])
def test_ladder_kernel_deals_more_chases_than_warps(cuda_device, stack_cap):
    """The swarms hold 48 capture and 12 escape starts, more than the
    kernel's 8 warps, which take them in whatever order they finish: 32
    copies of each, read twice, all read as the plain version."""
    stress = boards.ladder_stress()
    one = boards.from_stones(stress[2:4], cuda_device)
    want = LK.ladder_planes_plain(*_ladder_args(one), stack_cap=stack_cap)
    many = boards.from_stones(stress[2:4] * 32, cuda_device)
    for _ in range(2):
        got = LK.ladder_planes_kernel(*_ladder_args(many),
                                      stack_cap=stack_cap)
        for g, w in zip(got, want):
            assert torch.equal(g, w.repeat(32, 1))


@pytest.mark.cuda
def test_ladder_kernel_checked_build_matches_plain(cuda_device):
    """The bounds-checked build (-DDG_CHECK) traps on no board and reads
    as the plain version."""
    for states in (_curated(cuda_device),
                   _boards(256, cuda_device, seed=11)[0]):
        got = LK.ladder_planes_checked(*_ladder_args(states))
        torch.cuda.synchronize()
        want = LK.ladder_planes_plain(*_ladder_args(states))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 256, 1024])
def test_libs_after_kernel_matches_plain(cuda_device, batch):
    states, _ = _boards(batch, cuda_device, seed=batch + 2)
    rows = layout.pack_states(states)
    before = LA.launches
    got = LA.features_raw(rows[0], rows[1])
    torch.cuda.synchronize()
    assert LA.launches == before + 1
    assert torch.equal(got, LA.features_raw_plain(rows[0], rows[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [0, 256])
def test_libs_after_kernel_on_scripted_boards(cuda_device, batch):
    """The boards that reach the kernel's counting paths
    (``boards.FEATURE_CASES`` and their colour swaps: a capture through two
    stones, one own chain through two sides, two and three own chains, an
    own chain and a capture, a stone captured with its chain, a single
    stone, edges and corners, a chain over every word, ~280 chains): alone,
    then ahead of random boards; all five rows at every point."""
    states = boards.feature_cases(cuda_device)
    if batch:
        rand, _ = _boards(batch - states.batch, cuda_device, seed=batch + 6)
        states = _cat([states, rand])
    rows = layout.pack_states(states)
    got = LA.features_raw(rows[0], rows[1])
    torch.cuda.synchronize()
    assert torch.equal(got, LA.features_raw_plain(rows[0], rows[1]))


@pytest.mark.cuda
def test_libs_after_checked_build_matches_plain(cuda_device):
    """The bounds-checked build (-DDG_CHECK) traps on no board and counts as
    the plain version: the scripted boards, the ladder stress and capture
    boards and random ones, 1024 in all."""
    cases = _cat([boards.feature_cases(cuda_device), _curated(cuda_device)])
    rand, _ = _boards(1024 - cases.batch, cuda_device, seed=19)
    rows = layout.pack_states(_cat([cases, rand]))
    got = LA.features_raw_checked(rows[0], rows[1])
    torch.cuda.synchronize()   # a trap in the checked build raises here
    assert torch.equal(got, LA.features_raw_plain(rows[0], rows[1]))


@pytest.mark.cuda
def test_ladder_and_libs_after_reject_bad_inputs(cuda_device):
    states, _ = _boards(2, cuda_device, seed=0)
    st, cid, tm = _ladder_args(states)
    with pytest.raises(TypeError):
        LK.ladder_planes_kernel(st, cid, tm.long())
    with pytest.raises(ValueError):
        LK.ladder_planes_kernel(st, cid.cpu(), tm)
    with pytest.raises(ValueError):
        LK.ladder_planes_kernel(st[:, :, :361].contiguous(), cid, tm)
    with pytest.raises(ValueError):
        LK.ladder_planes_kernel(st, cid, tm, stack_cap=9)
    with pytest.raises(TypeError):
        LA.features_raw(st.to(torch.int16), cid)
    with pytest.raises(ValueError):
        LA.features_raw(st, cid.cpu())
    with pytest.raises(ValueError):
        LA.features_raw(st[:1], cid)


# ---------------------------------------------------------------------------
# the env-step kernel (K4)

from dream_go_torch.ops import env_step as E  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 256, 1024])
def test_env_step_kernel_matches_plain(cuda_device, batch):
    states, _ = _boards(batch, cuda_device, seed=batch + 3)
    # board 0 plays its ko capture: white's recapture is then a super-ko;
    # board 2 has the pass slot
    idx = torch.arange(batch, device=cuda_device)
    states = ko_captured(states, idx == 0)
    rows = [t.contiguous() for t in layout.pack_states(states)]
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    for name, w, bits in env_step_cases(states, gen, ko=idx == 0,
                                        pass_slots=idx == 2):
        before = E.launches
        got, moves = E.env_step(*rows, w, 12345, bits)
        torch.cuda.synchronize()
        assert E.launches == before + 1
        want, want_moves = E.env_step_plain(*rows, w, 12345, bits)
        assert torch.equal(moves, want_moves), name
        for g, x in zip(got, want):
            assert torch.equal(g, x), name
        if name == "one-hot":
            assert int(moves[0]) == 361        # the super-ko point passes
        if name == "zero":
            assert bool((moves == 361).all())


@pytest.mark.cuda
def test_env_step_kernel_chained_steps(cuda_device):
    """200 Philox steps at B=256 from fresh boards, kernel and plain
    compared after every step."""
    states = engine.new_states(256, device=cuda_device)
    rows = layout.pack_states(states)
    w = torch.ones(256, 361, device=cuda_device)
    for t in range(200):
        got, moves = E.env_step(*rows, w, t)
        want, want_moves = E.env_step_plain(*rows, w, t)
        assert torch.equal(moves, want_moves), t
        for g, x in zip(got, want):
            assert torch.equal(g, x), t
        rows = got


def _env_equal(fn, states, w, seed, bits=None):
    rows = [t.contiguous() for t in layout.pack_states(states)]
    got, moves = fn(*rows, w, seed, bits)
    torch.cuda.synchronize()   # a trap in the checked build raises here
    want, want_moves = E.env_step_plain(*rows, w, seed, bits)
    assert torch.equal(moves, want_moves)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    return moves


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 16, 256])
def test_env_step_kernel_on_scripted_boards(cuda_device, batch):
    """The boards that reach the kernel's paths (a capture through two
    neighbours, suicide, own chains of one and two liberties, a merge of
    three, super-kos in a wrapped ring and through a two-sided capture, a
    ring entry that only the exact compare clears, a finished board, a
    pass slot): each alone at B=1, else ahead of random boards; one-hot
    weights with Philox and with given words."""
    cases, cw, cmoves = env_cases(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(batch)
    if batch == 1:
        for i in range(cases.batch):
            one = torch.tensor([i], device=cuda_device)
            moves = _env_equal(E.env_step, cases.index(one), cw[one], 3)
            assert int(moves[0]) == int(cmoves[i]), ENV_CASES[i][0]
        return
    rand, _ = _boards(batch - cases.batch, cuda_device, seed=batch + 5)
    states = _cat([cases, rand])
    w = torch.cat([cw, torch.ones(rand.batch, 361, device=cuda_device)])
    bits = torch.randint(-2**31, 2**31, (batch, 361), generator=gen,
                         device=cuda_device,
                         dtype=torch.int64).to(torch.int32)
    for given in (None, bits):
        moves = _env_equal(E.env_step, states, w, 3, given)
        assert torch.equal(moves[:cases.batch], cmoves)


@pytest.mark.cuda
def test_env_step_checked_build_matches_plain(cuda_device):
    """The bounds-checked build (-DDG_CHECK) traps on no board and steps as
    the plain version: the scripted boards and random ones, 1024 in all,
    with Philox and given words, then 70 chained steps at B=256 (the ring
    wraps)."""
    cases, cw, _ = env_cases(cuda_device)
    rand, _ = _boards(1024 - cases.batch, cuda_device, seed=17)
    states = _cat([cases, rand])
    w = torch.cat([cw, torch.ones(rand.batch, 361, device=cuda_device)])
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    bits = torch.randint(-2**31, 2**31, (1024, 361), generator=gen,
                         device=cuda_device,
                         dtype=torch.int64).to(torch.int32)
    for given in (None, bits):
        _env_equal(E.env_step_checked, states, w, 4, given)
    rows = layout.pack_states(engine.new_states(256, device=cuda_device))
    w = torch.ones(256, 361, device=cuda_device)
    for t in range(70):
        got, moves = E.env_step_checked(*rows, w, t)
        want, want_moves = E.env_step_plain(*rows, w, t)
        assert torch.equal(moves, want_moves), t
        for g, x in zip(got, want):
            assert torch.equal(g, x), t
        rows = got


@pytest.mark.cuda
def test_env_step_rejects_bad_inputs(cuda_device):
    states, _ = _boards(2, cuda_device, seed=0)
    rows = list(layout.pack_states(states))
    w = torch.ones(2, 361, device=cuda_device)
    with pytest.raises(TypeError):
        E.env_step(*rows, w.double(), 0)
    with pytest.raises(ValueError):
        E.env_step(*rows, w.cpu(), 0)
    with pytest.raises(ValueError):
        E.env_step(*rows, torch.ones(2, 384, device=cuda_device), 0)
    with pytest.raises(TypeError):
        E.env_step(*rows, w, 0, torch.zeros(2, 361, dtype=torch.int64,
                                            device=cuda_device))
    bad = list(rows)
    bad[3] = rows[3][:, :, :64].contiguous()
    with pytest.raises(ValueError):
        E.env_step(*bad, w, 0)
    short = engine.new_states(2, history_len=32, device=cuda_device)
    with pytest.raises(ValueError):
        E.env_step_states(short, w, 0)


# ---------------------------------------------------------------------------
# the select walk

import functools  # noqa: E402

from dream_go_torch.mcts import search as S  # noqa: E402
from dream_go_torch.mcts import walk_cases as WC  # noqa: E402
from dream_go_torch.ops import select_walk as SW  # noqa: E402
from dream_go_torch.utils import spans  # noqa: E402

#: simulations that grow the walk's trees (capacity SIMS + 1)
WALK_SIMS = 200
WALK_OUTPUTS = ("node", "action", "k_exit", "path_n", "path_k", "root_a")


@functools.lru_cache(maxsize=None)
def _grown(batch, slots):
    return WC.grown_trees(torch.device("cuda"), batch, WALK_SIMS, slots=slots,
                          seed=batch + slots)


def _walk_equal(fn, t, cfg):
    """Raise unless ``fn``'s walk equals the plain walk's bit for bit;
    returns the plain walk's outputs."""
    b, c = t.node_n.shape
    got = fn(t, cfg.uct_exp, cfg.fpu_reduce, b, c)
    torch.cuda.synchronize()   # a trap in the checked build raises here
    want = SW.select_walk_plain(t, cfg.uct_exp, cfg.fpu_reduce, b, c)
    for name, g, w in zip(WALK_OUTPUTS, got, want):
        assert g.dtype == w.dtype == torch.int32, name
        assert g.shape == w.shape, name
        assert torch.equal(g, w), (name, (g != w).nonzero()[:10].tolist())
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [32, 2])
@pytest.mark.parametrize("batch", [1, 7, 256, 1024])
def test_select_walk_kernel_matches_plain(cuda_device, batch, slots):
    """Trees grown by the port's search (flat, peaked and hashed priors),
    then the same trees with their statistics redrawn, three of them with
    roots that have no candidate."""
    t, cfg = _grown(batch, slots)
    before = SW.launches
    want = _walk_equal(SW.select_walk, t, cfg)
    assert SW.launches == before + 1
    if batch >= 256:
        assert int((want[3] >= 0).sum(1).max()) >= 8   # some walks go deep
    if batch >= 256 and slots == 2:
        # full-slot nodes force slot use on some walks
        full = (t.slot_action >= 0).all(-1)
        rows = torch.arange(batch, device=cuda_device)[:, None]
        assert bool(full[rows, want[3].clamp(min=0)][:, 1:].any())
    for seed in range(3):
        n = min(batch, 3)
        want = _walk_equal(SW.select_walk, WC.perturbed(t, seed, n), cfg)
        assert bool((want[5][:n] == S.A - 1).all())


@pytest.mark.cuda
def test_select_walk_kernel_at_the_depth_bound(cuda_device):
    """A line deeper than MAX_BACKUP_DEPTH: the walk stops at 128 levels on
    an existing edge (k_exit >= 0), as the plain walk does; equal priors
    (a flat policy) tie, and the first index wins."""
    t, cfg = WC.line_trees(cuda_device)
    want = _walk_equal(SW.select_walk, t, cfg)
    assert bool((want[2] >= 0).all()) and bool((want[3] >= 0).all())
    assert want[3].shape[1] == SW.MAX_BACKUP_DEPTH
    flat, fcfg = WC.grown_trees(cuda_device, 16, 24, seed=3)
    flat.prior.fill_(1.0 / 8.0)
    flat.root_edge_n.zero_()
    want = _walk_equal(SW.select_walk, flat, fcfg)
    cand0 = SW.unpack_cand(flat.cand[:, 0])
    first = torch.argmax(cand0.to(torch.int8), 1).to(torch.int32)
    assert torch.equal(want[5], first)


@pytest.mark.cuda
def test_select_walk_checked_build_matches_plain(cuda_device):
    """The bounds-checked build (-DDG_CHECK) traps on no tree and walks
    as the plain version: the grown, redrawn and line trees."""
    for slots in (32, 2):
        t, cfg = _grown(1024, slots)
        _walk_equal(SW.select_walk_checked, t, cfg)
        _walk_equal(SW.select_walk_checked, WC.perturbed(t, 7, 3), cfg)
    line, cfg = WC.line_trees(cuda_device)
    _walk_equal(SW.select_walk_checked, line, cfg)


@pytest.mark.cuda
def test_select_walk_rejects_bad_inputs(cuda_device):
    import dataclasses

    t, cfg = _grown(7, 32)
    args = (cfg.uct_exp, cfg.fpu_reduce, 7, t.node_n.shape[1])
    with pytest.raises(TypeError):
        SW.select_walk(dataclasses.replace(t, slot_n=t.slot_n.long()), *args)
    with pytest.raises(ValueError):
        SW.select_walk(dataclasses.replace(t, slot_w=t.slot_w.cpu()), *args)
    with pytest.raises(ValueError):
        SW.select_walk(dataclasses.replace(
            t, root_edge_w=t.root_edge_w.t().contiguous().t()), *args)
    with pytest.raises(ValueError):
        SW.select_walk(t, cfg.uct_exp, cfg.fpu_reduce, 7, 1)


@pytest.mark.cuda
def test_search_counts_a_walk_launch_per_simulation(cuda_device,
                                                   monkeypatch):
    """On the card each simulation launches the walk once: the counter
    ``search.select.launches`` equals ``search.simulations``, no host loop
    runs (``iterations`` 0), and ``lane_trips`` and ``board_levels`` read
    as the plain loop counts them."""
    trees, cfg = WC.grown_trees(cuda_device, 64, 24, seed=9, capacity=40)
    walked = []
    select = S._select_flat

    def keep(*args, **kwargs):
        out = select(*args, **kwargs)
        levels = (out[3][:, 1:] >= 0).sum(1)
        walked.append((int(levels.sum()), int(levels.max())))
        return out

    b, c = trees.node_n.shape
    monkeypatch.setattr(S, "_select_flat", keep)
    with spans.recording():
        S.run_search(trees, WC.case_predictor(), cfg, 4, None)
    counters = spans.snapshot()["counters"]
    assert counters["search.simulations"] == 4
    assert counters["search.select.launches"] == 4
    assert counters.get("search.select.iterations", 0) == 0
    assert counters["search.select.board_levels"] == sum(n for n, _ in walked)
    d = min(c, SW.MAX_BACKUP_DEPTH)
    assert counters["search.select.lane_trips"] == sum(
        min(deepest + 1, d - 1) * b for _, deepest in walked)


# ---------------------------------------------------------------------------
# GTP serving and reanalyze


@pytest.mark.cuda
def test_gtp_and_reanalyze_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    """`chip_smoke.gtp_script` (deterministic predictor, 16 rollouts, no
    noise) gives the same answers on the card (leaf_step at every leaf)
    as on the CPU, and a reanalyzed sample game is the same line."""
    import re

    import chip_smoke as C
    from dream_go_torch.config import SearchConfig
    from dream_go_torch.gtp import GtpEngine
    from dream_go_torch.selfplay import reanalyze as RA

    game = tmp_path / "game.sgf"
    game.write_text(C.sample_lines()[2] + "\n")
    before = L.launches
    answers = [C.gtp_answers(GtpEngine(
        C.det_predictor(), SearchConfig(dirichlet_noise=0.0),
        num_rollout=16, device=dev), C.gtp_script(str(game)))
        for dev in (cuda_device, "cpu")]
    assert L.launches - before >= 5 * 16
    assert answers[0] == answers[1]
    lines = [RA.reanalyze(C.sample_lines()[2:], C.det_predictor(),
                          SearchConfig(dirichlet_noise=0.0, adaptive=False),
                          num_sims=16, device=dev)
             for dev in (cuda_device, "cpu")]
    card, host = [[re.sub(r"DT\[[^\]]*\]", "", x) for x in ls]
                  for ls in lines]
    assert card == host and "TV[16]" in card[0]


# ---------------------------------------------------------------------------
# the trainer slice

#: the first eight games of the rl20 run, the trainer tests' data
RL20_GAMES = "tests/fixtures/rl20_gen0000_first8.sgf"
#: a bf16 train step's losses against float32's (TF32 off) from the same
#: weights and batch, relative: bf16 keeps 8 bits of mantissa (a relative
#: rounding of 2^-9 ~ 2e-3 an operation), and the losses are means over
#: the batch of 19 layers' worth of such roundings
BF16_LOSS_RTOL = 2e-2


def _rl20_lines():
    with open(RL20_GAMES) as fh:
        return [line.strip() for line in fh if line.strip()]


def _game_positions(dev, per_game: int, seed: int = 0):
    """``per_game`` positions drawn from each of the eight rl20 games,
    replayed as the trainer replays them: 8 x ``per_game`` boards."""
    import numpy as np

    from dream_go_torch.selfplay.replay import states_at_multi
    from dream_go_torch.train import pipeline as P

    games = [P.parse_game(line) for line in _rl20_lines()]
    t_max = max(len(g.moves) for g in games)
    moves = np.full((len(games), t_max), 361, np.int32)
    rng = np.random.default_rng(seed)
    targets = np.stack([rng.integers(0, len(g.moves), per_game)
                        for g in games]).astype(np.int32)
    for i, g in enumerate(games):
        moves[i, :len(g.moves)] = g.moves
    komi = torch.tensor([g.komi for g in games], dtype=torch.float32,
                        device=dev)
    states = states_at_multi(torch.as_tensor(moves, device=dev),
                             torch.as_tensor(targets, device=dev), komi, 16)
    return engine.GoState(**{k: v.reshape((-1,) + v.shape[2:])
                             for k, v in states.fields().items()})


@pytest.mark.cuda
def test_trainer_chunk_kernels_match_plain(cuda_device):
    """The ladder and feature kernels on positions of real games at the
    pipeline's chunk (``FEATURE_CHUNK`` = 1024 boards), and the chunk's
    planes (ladders off) against the plain V1 planes."""
    from dream_go_torch.go import features
    from dream_go_torch.train import pipeline as P

    states = _game_positions(cuda_device, P.FEATURE_CHUNK // 8)
    assert states.batch == P.FEATURE_CHUNK
    rows = layout.pack_states(states)
    assert torch.equal(LA.features_raw(rows[0], rows[1]),
                       LA.features_raw_plain(rows[0], rows[1]))
    got = LK.ladder_planes_kernel(*_ladder_args(states))
    want = LK.ladder_planes_plain(*_ladder_args(states))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].sum()) + int(got[1].sum()) > 0
    before = LA.launches
    assert torch.equal(P.planes(states, False),
                       features.extract_batch(states, False, False, False))
    assert LA.launches == before + 1


@pytest.mark.cuda
def test_train_step_bf16_close_to_float32(cuda_device):
    """One 128 x 9 train step at B = 64 on a bank of the rl20 games: the
    bf16 step's losses are finite and within ``BF16_LOSS_RTOL`` of the
    float32 step's, from the same weights and batch."""
    import math

    from dream_go_torch.config import ModelConfig, TrainConfig
    from dream_go_torch.train import pipeline as P
    from dream_go_torch.train import train_loop as TL

    src = P.ExampleSource(_rl20_lines(), 64, seed=0, positions_per_game=8,
                          bank_games=8, device=cuda_device)
    feats, labels = next(iter(src.batches(1)))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = {}
        for dtype in ("float32", "bfloat16"):
            tr = TL.Trainer.create(ModelConfig(compute_dtype=dtype),
                                   TrainConfig(batch_size=64), seed=0,
                                   device=cuda_device)
            got[dtype] = {k: float(v) for k, v in TL.train_step(
                tr.model, tr.optimizer, tr.train_cfg, feats, labels,
                3e-4).items()}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    for k in ("loss", "loss_policy", "loss_value", "loss_ownership"):
        a, b = got["bfloat16"][k], got["float32"][k]
        assert math.isfinite(a) and abs(a - b) <= BF16_LOSS_RTOL * abs(b), \
            (k, a, b)


#: the card's float32 teacher (TF32 off) against the CPU's: cuDNN and the
#: CPU sum the convolutions in other orders
LZ_VALUE_ATOL, LZ_POLICY_ATOL = 1e-4, 1e-5


@pytest.mark.cuda
def test_rl_loop_generation_on_the_card(cuda_device, tmp_path):
    """One generation of the RL loop at 16 x 2, B = 64 on the card: policy
    play and ex-it with planes 30/31, a bank, 4 steps; its files, a finite
    loss, and K1, K2 and K3 launched (K4 not)."""
    import math
    import os
    import re

    from dream_go_torch.config import (ModelConfig, SearchConfig,
                                       SelfPlayConfig, TrainConfig)
    from dream_go_torch.ops import env_step as E
    from dream_go_torch.ops import ladder_kernel as LK
    from dream_go_torch.ops import libs_after as LA
    from dream_go_torch.train import rl_loop as R

    mods = (L, LK, LA, E)
    before = [m.launches for m in mods]
    logs = []
    trainer = R.run_rl_loop(
        ModelConfig(num_channels=16, num_blocks=2, num_samples=2,
                    ladder_features=True),
        TrainConfig(batch_size=64),
        SelfPlayConfig(num_games=8, num_rollout=8, max_moves=60,
                       ladder_features=True),
        SearchConfig(num_rollout=8, ladder_features=True),
        R.RLLoopConfig(generations=1, games_per_generation=8,
                       train_steps_per_generation=4, bank_games=8,
                       ex_it_batch=64, out_dir=str(tmp_path), seed=0),
        log_fn=logs.append, device=cuda_device)
    torch.cuda.synchronize()
    k1, k2, k3, k4 = (m.launches - b for m, b in zip(mods, before))
    assert k1 > 0 and k2 > 0 and k3 > 0 and k4 == 0, (k1, k2, k3, k4)
    assert trainer.step == 4
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_0000", "dream_go.json", "gen_0000.sgf", "weights_0000.json"]
    loss = float(re.search(r"gen 0: loss (\S+)", "\n".join(logs)).group(1))
    assert math.isfinite(loss)
    tower = R.serving_tower(trainer, cuda_device)
    assert next(tower.parameters()).dtype == torch.bfloat16


@pytest.mark.cuda
def test_lz_teacher_on_the_card_matches_cpu(cuda_device):
    import numpy as np

    from dream_go_torch.models import leela_zero as LZ

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    w = LZ.random_weights(64, 3, seed=1)
    x = (np.random.default_rng(0).random((8, 19, 19, 18)) > 0.5).astype(
        np.float32)
    v, p = LZ.teacher(w, cuda_device)(torch.from_numpy(x).to(cuda_device))
    v32, p32 = LZ.teacher(w, "cpu")(torch.from_numpy(x))
    assert v.device.type == "cuda" and v.dtype == torch.float32
    assert float((v.cpu() - v32).abs().max()) <= LZ_VALUE_ATOL
    assert float((p.cpu() - p32).abs().max()) <= LZ_POLICY_ATOL
    # the teacher restores the TF32 settings it turned off
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == tf32
