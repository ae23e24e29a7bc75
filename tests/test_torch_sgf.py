"""The port's SGF reader (`dream_go_torch.utils.sgf`) against the JAX
package's on the committed game records."""

import glob

import numpy as np
import pytest

from dream_go_tpu.utils import sgf as jsgf
from dream_go_torch.utils import sgf as tsgf

FILES = sorted(glob.glob("tests/fixtures/sanity/*.sgf"))


def _lines():
    with open("tests/fixtures/sample_games.sgf") as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    for path in FILES:
        with open(path) as fh:
            lines.append(fh.read().replace("\n", ""))
    return lines


def _same(got, want):
    if want is None:
        return got is None
    if (got.komi, got.winner, got.score, got.by_resign,
            got.black_territory, got.white_territory) != (
            want.komi, want.winner, want.score, want.by_resign,
            want.black_territory, want.white_territory):
        return False
    if len(got.moves) != len(want.moves):
        return False
    for g, w in zip(got.moves, want.moves):
        if (g.color, g.point, g.value, g.num_rollout) != (
                w.color, w.point, w.value, w.num_rollout):
            return False
        if (g.policy is None) != (w.policy is None):
            return False
        if g.policy is not None and not np.array_equal(g.policy, w.policy):
            return False
    return True


@pytest.mark.parametrize("index", range(len(FILES) + 1))
def test_parse_line_matches(index):
    lines = _lines()
    if index == len(FILES):  # every line of the sample games
        todo = lines[:-len(FILES)]
        assert len(todo) > 0
    else:
        todo = [lines[len(lines) - len(FILES) + index]]
    for line in todo:
        assert _same(tsgf.parse_line(line), jsgf.parse_line(line))
        assert tsgf.get_komi(line) == jsgf.get_komi(line)
        assert tsgf.get_winner(line) == jsgf.get_winner(line)
        assert tsgf.is_scored(line) == jsgf.is_scored(line)


def test_self_play_annotations_round_trip():
    line = ("(;GM[1]FF[4]DT[x]SZ[19]RU[Chinese]KM[7.5]RE[B+2.5];B[dd]TV[64]"
            "P[" + "0" * 905 + "]V[0.1250];W[]TV[8]V[-0.5000]TB[aa][ab]TW[ss])")
    for fn in ("parse_line",):
        got = getattr(tsgf, fn)(line)
        want = getattr(jsgf, fn)(line)
        assert _same(got, want)
        assert got.moves[0].num_rollout == 64 and got.moves[1].point == 361
