"""Slow, obviously-correct pure-Python Go engine used as a test oracle.

Port of `dream_go_tpu/go/reference.py`, kept as a copy so that the port
never imports the JAX package.  It stands in for the reference's Rust
`BoardFast` (`src/libdg_go/board_fast.rs`): the batched engine
(`go/engine.py`) and the ladder readers (`go/ladder.py`, the ladder
kernel) are fuzzed against it (same rules: Tromp-Taylor legality with
suicide forbidden, positional super-ko over a bounded history window, the
same zobrist table, so its hashes are the JAX oracle's).  Plain Python
sets and flood fills, no clever data structures, so its bugs are unlikely
to correlate with the vectorised code.  ``_l_capture`` is the recursive
ladder reader of `utils/ladder.rs`.
"""

from __future__ import annotations

import numpy as np

from .topology import NN, PASS
from .zobrist import Z

N = 19
EMPTY, BLACK, WHITE = 0, 1, 2


def neighbors(p: int):
    x, y = p % N, p // N
    if y > 0:
        yield p - N
    if x > 0:
        yield p - 1
    if x < N - 1:
        yield p + 1
    if y < N - 1:
        yield p + N


class PyBoard:
    """Mutable single board with full rule support."""

    def __init__(self, komi: float = 7.5, history_len: int = 64):
        self.stones = [EMPTY] * NN
        self.to_move = BLACK
        self.komi = komi
        self.history_len = history_len
        self.hash = (0, 0)
        self.hash_history: list[tuple[int, int]] = []  # most recent last
        self.last_two = [PASS, PASS]
        self.move_count = 0
        self.pass_count = 0
        self.done = False

    # -- chains ------------------------------------------------------------

    def chain_at(self, p: int) -> set[int]:
        color = self.stones[p]
        assert color != EMPTY
        seen = {p}
        frontier = [p]
        while frontier:
            q = frontier.pop()
            for r in neighbors(q):
                if self.stones[r] == color and r not in seen:
                    seen.add(r)
                    frontier.append(r)
        return seen

    def liberties(self, chain: set[int]) -> set[int]:
        libs = set()
        for q in chain:
            for r in neighbors(q):
                if self.stones[r] == EMPTY:
                    libs.add(r)
        return libs

    def num_liberties(self, p: int) -> int:
        return len(self.liberties(self.chain_at(p)))

    def analysis(self):
        """One flood-fill pass: (chain_map[361] -> rep id, libs_by_rep dict)."""
        chain_map = [-1] * NN
        libs_by_rep: dict[int, set[int]] = {}
        members_by_rep: dict[int, list[int]] = {}
        for p in range(NN):
            if self.stones[p] != EMPTY and chain_map[p] == -1:
                chain = self.chain_at(p)
                rep = min(chain)
                for q in chain:
                    chain_map[q] = rep
                libs_by_rep[rep] = self.liberties(chain)
                members_by_rep[rep] = sorted(chain)
        return chain_map, libs_by_rep, members_by_rep

    # -- rules -------------------------------------------------------------

    def _hash_xor(self, h, color, p):
        z = Z[color - 1, p]
        return (h[0] ^ int(z[0]), h[1] ^ int(z[1]))

    def hash_after(self, color: int, p: int):
        """Post-move hash assuming the move is pseudo-legal."""
        h = self._hash_xor(self.hash, color, p)
        opp = 3 - color
        seen = set()
        for q in neighbors(p):
            if self.stones[q] == opp and q not in seen:
                chain = self.chain_at(q)
                if self.liberties(chain) == {p}:
                    seen |= chain
                    for r in chain:
                        h = self._hash_xor(h, opp, r)
        return h

    def is_pseudo_legal(self, color: int, p: int) -> bool:
        if p == PASS:
            return True
        if self.stones[p] != EMPTY:
            return False
        opp = 3 - color
        for q in neighbors(p):
            if self.stones[q] == EMPTY:
                return True
            n = self.num_liberties(q)
            if self.stones[q] == color and n >= 2:
                return True
            if self.stones[q] == opp and n == 1:
                return True
        return False

    def is_legal(self, color: int, p: int) -> bool:
        if p == PASS:
            return True
        if self.done:
            return False
        if not self.is_pseudo_legal(color, p):
            return False
        h = self.hash_after(color, p)
        window = self.hash_history[-self.history_len:]
        return h not in window

    def legal_mask(self, color: int | None = None) -> np.ndarray:
        """Full legal mask using one shared chain analysis (fast path)."""
        color = self.to_move if color is None else color
        out = np.zeros(NN + 1, dtype=bool)
        out[PASS] = True
        if self.done:
            return out
        opp = 3 - color
        chain_map, libs_by_rep, members_by_rep = self.analysis()
        window = set(self.hash_history[-self.history_len:])
        for p in range(NN):
            if self.stones[p] != EMPTY:
                continue
            pseudo = False
            caps: list[int] = []
            for q in neighbors(p):
                if self.stones[q] == EMPTY:
                    pseudo = True
                else:
                    rep = chain_map[q]
                    nlibs = len(libs_by_rep[rep])
                    if self.stones[q] == color and nlibs >= 2:
                        pseudo = True
                    elif self.stones[q] == opp and nlibs == 1:
                        pseudo = True
                        if rep not in caps:
                            caps.append(rep)
            if not pseudo:
                continue
            h = self._hash_xor(self.hash, color, p)
            for rep in caps:
                for r in members_by_rep[rep]:
                    h = self._hash_xor(h, opp, r)
            out[p] = h not in window
        return out

    def play(self, action: int):
        if self.done:
            return
        if action == PASS:
            self.pass_count += 1
            self.move_count += 1
            self.to_move = 3 - self.to_move
            if self.pass_count >= 2:
                self.done = True
            return
        color = self.to_move
        opp = 3 - color
        p = action
        assert self.stones[p] == EMPTY, f"occupied point {p}"
        self.stones[p] = color
        self.hash = self._hash_xor(self.hash, color, p)
        # capture opponent chains with no liberties
        for q in list(neighbors(p)):
            if self.stones[q] == opp:
                chain = self.chain_at(q)
                if not self.liberties(chain):
                    for r in chain:
                        self.stones[r] = EMPTY
                        self.hash = self._hash_xor(self.hash, opp, r)
        # suicide is illegal; assert rather than implement clearing
        assert self.liberties(self.chain_at(p)), "suicide played"
        self.hash_history.append(self.hash)
        self.last_two = [p, self.last_two[0]]
        self.move_count += 1
        self.pass_count = 0
        self.to_move = opp

    # -- views -------------------------------------------------------------

    def stones_array(self) -> np.ndarray:
        return np.asarray(self.stones, dtype=np.int8)

    def liberty_map(self) -> np.ndarray:
        """int32[361]: liberty count of the chain at each point, 0 if empty."""
        out = np.zeros(NN, dtype=np.int32)
        chain_map, libs_by_rep, _ = self.analysis()
        for p in range(NN):
            if self.stones[p] != EMPTY:
                out[p] = len(libs_by_rep[chain_map[p]])
        return out

    # -- ladders (faithful recursive port of `utils/ladder.rs`) -------------

    def _l_place(self, stones: list[int], color: int, p: int) -> list[int]:
        stones = list(stones)
        opp = 3 - color
        stones[p] = color
        for q in neighbors(p):
            if stones[q] == opp:
                chain = _l_chain(stones, q)
                if not _l_libs(stones, chain):
                    for r in chain:
                        stones[r] = EMPTY
        return stones

    def is_ladder_capture(self, color: int, p: int,
                          max_depth: int | None = None) -> bool:
        return _l_capture(self._l_place(list(self.stones), color, p), color,
                          p, 0, max_depth)

    def is_ladder_escape(self, color: int, p: int,
                         max_depth: int | None = None) -> bool:
        stones = list(self.stones)
        opp = 3 - color
        connected = any(
            stones[q] == color and len(_l_libs(stones, _l_chain(stones, q))) < 2
            for q in neighbors(p))
        if not connected:
            return False
        stones = self._l_place(stones, color, p)
        if len(_l_libs(stones, _l_chain(stones, p))) != 2:
            return False
        for q in neighbors(p):
            if _l_valid(stones, opp, q) and _l_capture(
                    self._l_place(stones, opp, q), opp, q, 0, max_depth):
                return False
        return True

    def liberties_if(self, color: int, p: int) -> int:
        """Exact liberty count of the chain formed by playing at p.

        Mirrors `board_fast.rs:484-539` (`get_n_liberty_if`) including capture
        handling; assumes the move is pseudo-legal.
        """
        assert self.stones[p] == EMPTY
        opp = 3 - color
        captured: set[int] = set()
        for q in neighbors(p):
            if self.stones[q] == opp:
                chain = self.chain_at(q)
                if self.liberties(chain) == {p}:
                    captured |= chain
        members = {p}
        for q in neighbors(p):
            if self.stones[q] == color:
                members |= self.chain_at(q)
        libs = set()
        for q in members:
            for r in neighbors(q):
                if r == p:
                    continue
                if self.stones[r] == EMPTY or r in captured:
                    libs.add(r)
        return len(libs)


# -- module-level ladder helpers (list-of-int board, `utils/ladder.rs`) ------


def _l_chain(stones: list[int], p: int) -> list[int]:
    color = stones[p]
    seen = {p}
    frontier = [p]
    while frontier:
        q = frontier.pop()
        for r in neighbors(q):
            if stones[r] == color and r not in seen:
                seen.add(r)
                frontier.append(r)
    return sorted(seen)


def _l_libs(stones: list[int], chain) -> set[int]:
    libs = set()
    for q in chain:
        for r in neighbors(q):
            if stones[r] == EMPTY:
                libs.add(r)
    return libs


def _l_valid(stones: list[int], color: int, p: int) -> bool:
    if stones[p] != EMPTY:
        return False
    opp = 3 - color
    for q in neighbors(p):
        if stones[q] == EMPTY:
            return True
        n = len(_l_libs(stones, _l_chain(stones, q)))
        if stones[q] == color and n >= 2:
            return True
        if stones[q] == opp and n == 1:
            return True
    return False


def _l_can_counter(stones: list[int], color: int, chain) -> bool:
    """`ladder.rs:34-42`: can the opp-colored `chain` capture an adjacent
    `color` chain in atari?"""
    for q in chain:
        for r in neighbors(q):
            if stones[r] == color and \
                    len(_l_libs(stones, _l_chain(stones, r))) < 2:
                return True
    return False


#: practical recursion cap for the oracle (the reference recursion is
#: unbounded, `ladder.rs:53-119`; 80 covers every real-game ladder).  The
#: stress tests raise it to follow adversarial whole-board chases.
LADDER_MAX_DEPTH = 80


def _l_capture(stones: list[int], color: int, p: int, depth: int = 0,
               max_depth: int | None = None) -> bool:
    """Board state is *after* placing color at p (`_is_ladder_capture`)."""
    if max_depth is None:
        max_depth = LADDER_MAX_DEPTH
    if depth > max_depth:
        return False
    opp = 3 - color
    ext = None
    for q in neighbors(p):
        if stones[q] == opp:
            chain = _l_chain(stones, q)
            libs = _l_libs(stones, chain)
            if len(libs) < 2 and not _l_can_counter(stones, color, chain):
                lone = next(iter(libs)) if libs else None
                if lone is not None and _l_valid(stones, opp, lone):
                    ext = lone
                    break
    if ext is None:
        return False
    stones2 = list(stones)
    stones2[ext] = opp
    for q in neighbors(ext):  # the extension may itself capture
        if stones2[q] == color:
            ch = _l_chain(stones2, q)
            if not _l_libs(stones2, ch):
                for t in ch:
                    stones2[t] = EMPTY
    chain = _l_chain(stones2, ext)
    libs = _l_libs(stones2, chain)
    if len(libs) < 2:
        return True
    if len(libs) >= 3:
        return False
    for q in neighbors(ext):
        if stones2[q] == color and \
                len(_l_libs(stones2, _l_chain(stones2, q))) < 2:
            return False
    for q in neighbors(ext):
        if _l_valid(stones2, color, q):
            s3 = list(stones2)
            s3[q] = color
            for r in neighbors(q):
                if s3[r] == opp:
                    ch = _l_chain(s3, r)
                    if not _l_libs(s3, ch):
                        for t in ch:
                            s3[t] = EMPTY
            if _l_capture(s3, color, q, depth + 1, max_depth):
                return True
    return False
