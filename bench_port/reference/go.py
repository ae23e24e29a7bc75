"""Plain Go rules, the V1 input planes, Benson's unconditional life and the
search's candidate masks, one board at a time in Python and NumPy.

The yardstick the search and training cells hold the program's boards,
planes and masks against.  The rules are Tromp-Taylor with suicide
forbidden and positional super-ko over the last ``history_len`` positions
(dream-go's `board_fast.rs`), hashed with dream-go's seeded zobrist table
(PCG64, seed 0x20260816, two 32-bit words a point and colour).  Plain sets
and flood fills, so that a fault here is unlikely to match a fault of a
batched implementation.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

N = 19
NN = N * N
PASS = NN
EMPTY, BLACK, WHITE = 0, 1, 2


def _zobrist() -> np.ndarray:
    rng = np.random.Generator(np.random.PCG64(0x20260816))
    return rng.integers(0, 2**32, size=(2, NN, 2), dtype=np.uint32)


#: [colour - 1, point, word] zobrist entries
Z = _zobrist()


def _neighbors(p: int) -> tuple[int, ...]:
    x, y = p % N, p // N
    out = []
    if y > 0:
        out.append(p - N)
    if x > 0:
        out.append(p - 1)
    if x < N - 1:
        out.append(p + 1)
    if y < N - 1:
        out.append(p + N)
    return tuple(out)


NBR = [_neighbors(p) for p in range(NN)]
_DIAG = []
for _p in range(NN):
    _x, _y = _p % N, _p // N
    _DIAG.append(tuple((_y + dy) * N + _x + dx
                       for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1))
                       if 0 <= _x + dx < N and 0 <= _y + dy < N))
_CORNER = [(p % N in (0, N - 1)) and (p // N in (0, N - 1))
           for p in range(NN)]
_EDGE = [((p % N in (0, N - 1)) or (p // N in (0, N - 1))) and not _CORNER[p]
         for p in range(NN)]
#: own neighbours a heuristic eye needs, across and diagonally
CROSS_NEED = [2 if _CORNER[p] else 3 if _EDGE[p] else 4 for p in range(NN)]
DIAG_NEED = [1 if _CORNER[p] else 2 if _EDGE[p] else 3 for p in range(NN)]


class Board:
    """One board with its move history."""

    def __init__(self, komi: float = 7.5, history_len: int = 64):
        self.stones = [EMPTY] * NN
        self.to_move = BLACK
        self.komi = float(komi)
        self.history_len = history_len
        self.hash = (0, 0)
        self.history: list[tuple[int, int]] = []  # most recent last
        self.last_two = [PASS, PASS]
        self.pass_count = 0
        self.done = False

    def copy(self) -> "Board":
        b = Board(self.komi, self.history_len)
        b.stones = list(self.stones)
        b.to_move, b.hash = self.to_move, self.hash
        b.history = list(self.history)
        b.last_two = list(self.last_two)
        b.pass_count, b.done = self.pass_count, self.done
        return b

    def chain_at(self, p: int) -> set[int]:
        color = self.stones[p]
        seen, frontier = {p}, [p]
        while frontier:
            q = frontier.pop()
            for r in NBR[q]:
                if self.stones[r] == color and r not in seen:
                    seen.add(r)
                    frontier.append(r)
        return seen

    def liberties(self, chain) -> set[int]:
        return {r for q in chain for r in NBR[q] if self.stones[r] == EMPTY}

    def analysis(self):
        """``(chain_of[361], libs{rep}, members{rep})``, rep = min member."""
        chain_of = [-1] * NN
        libs, members = {}, {}
        for p in range(NN):
            if self.stones[p] != EMPTY and chain_of[p] < 0:
                chain = self.chain_at(p)
                rep = min(chain)
                for q in chain:
                    chain_of[q] = rep
                libs[rep] = self.liberties(chain)
                members[rep] = chain
        return chain_of, libs, members

    def _xor(self, h, color, p):
        z = Z[color - 1, p]
        return (h[0] ^ int(z[0]), h[1] ^ int(z[1]))

    def play(self, action: int) -> None:
        """Play ``action`` (a point or PASS) for the side to move; a
        finished game stays as it is.  The move must be legal."""
        if self.done:
            return
        if action == PASS:
            self.pass_count += 1
            self.to_move = 3 - self.to_move
            self.done = self.pass_count >= 2
            return
        color, opp = self.to_move, 3 - self.to_move
        if self.stones[action] != EMPTY:
            raise ValueError(f"point {action} is occupied")
        self.stones[action] = color
        self.hash = self._xor(self.hash, color, action)
        for q in NBR[action]:
            if self.stones[q] == opp:
                chain = self.chain_at(q)
                if not self.liberties(chain):
                    for r in chain:
                        self.stones[r] = EMPTY
                        self.hash = self._xor(self.hash, opp, r)
        if not self.liberties(self.chain_at(action)):
            raise ValueError(f"suicide at {action}")
        self.history.append(self.hash)
        self.last_two = [action, self.last_two[0]]
        self.pass_count = 0
        self.to_move = opp

    # -- one analysis, every point -------------------------------------------

    def point_info(self, color: int, ana=None):
        """Per point, for ``color`` to play there: pseudo-legal (bool[361]),
        liberties of the chain it would form (int[361], 0 where not
        pseudo-legal) and whether it repeats a position of the history
        window (bool[361], False where not pseudo-legal)."""
        chain_of, libs, members = ana or self.analysis()
        opp = 3 - color
        window = set(self.history[-self.history_len:])
        pseudo = np.zeros(NN, bool)
        libs_if = np.zeros(NN, np.int32)
        repeat = np.zeros(NN, bool)
        for p in range(NN):
            if self.stones[p] != EMPTY:
                continue
            ok = False
            captured: set[int] = set()
            own: set[int] = set()
            for q in NBR[p]:
                s = self.stones[q]
                if s == EMPTY:
                    ok = True
                elif s == color:
                    own.add(chain_of[q])
                    if len(libs[chain_of[q]]) >= 2:
                        ok = True
                elif len(libs[chain_of[q]]) == 1:
                    ok = True
                    captured |= members[chain_of[q]]
            if not ok:
                continue
            pseudo[p] = True
            group = {p}
            for rep in own:
                group |= members[rep]
            libs_if[p] = len({r for q in group for r in NBR[q]
                              if r != p and (self.stones[r] == EMPTY
                                             or r in captured)})
            h = self._xor(self.hash, color, p)
            for r in captured:
                h = self._xor(h, opp, r)
            repeat[p] = h in window
        return pseudo, libs_if, repeat


def standard_mask(board: Board, ana=None) -> np.ndarray:
    """bool[362]: legal moves (super-ko included) and pass; a finished
    game allows only pass."""
    out = np.zeros(NN + 1, bool)
    out[PASS] = True
    if board.done:
        return out
    pseudo, _, repeat = board.point_info(board.to_move, ana)
    out[:NN] = pseudo & ~repeat
    return out


def benson(board: Board, color: int, ana=None):
    """``(alive, eye)`` bool[361] for ``color`` (`benson.rs`): regions are
    the connected sets of points without a ``color`` stone; a region is
    vital to a chain when each of its points touches the chain; chains
    with fewer than two healthy vital regions die, and regions touching a
    dead chain stop being healthy, until nothing changes."""
    chain_of, _, _ = ana or board.analysis()
    st = board.stones
    region_of = [-1] * NN
    regions = []
    for p in range(NN):
        if st[p] == color or region_of[p] >= 0:
            continue
        r = len(regions)
        region_of[p] = r
        pts, frontier = [p], [p]
        while frontier:
            q = frontier.pop()
            for s in NBR[q]:
                if st[s] != color and region_of[s] < 0:
                    region_of[s] = r
                    pts.append(s)
                    frontier.append(s)
        regions.append(pts)
    vital, touch = [], []
    for pts in regions:
        sets = [{chain_of[s] for s in NBR[q] if st[s] == color} for q in pts]
        vital.append(set.intersection(*sets))
        touch.append(set.union(*sets))
    healthy = [bool(v) for v in vital]
    while True:
        count: dict[int, int] = {}
        for r, v in enumerate(vital):
            if healthy[r]:
                for c in v:
                    count[c] = count.get(c, 0) + 1
        alive_chains = {c for c, n in count.items() if n >= 2}
        changed = False
        for r in range(len(regions)):
            if healthy[r] and not touch[r] <= alive_chains:
                healthy[r] = False
                changed = True
        if not changed:
            break
    alive = np.array([st[p] == color and chain_of[p] in alive_chains
                      for p in range(NN)])
    eye = np.array([st[p] != color and healthy[region_of[p]]
                    for p in range(NN)])
    return alive, eye


def life(board: Board, ana=None):
    ana = ana or board.analysis()
    return (*benson(board, BLACK, ana), *benson(board, WHITE, ana))


def is_scorable(board: Board, ana=None) -> bool:
    """Every point decided by Benson's life (`score.rs`)."""
    alive_b, eye_b, alive_w, eye_w = life(board, ana)
    st = np.asarray(board.stones)
    ok = np.where(st == EMPTY, eye_b | eye_w,
                  np.where(st == BLACK, alive_b | eye_w, alive_w | eye_b))
    return bool(ok.all())


def eye_heuristic(board: Board) -> np.ndarray:
    """bool[361]: playing here would fill one of the mover's own eyes
    (`options.rs`): enough own stones across and diagonally."""
    st, me = board.stones, board.to_move
    out = np.zeros(NN, bool)
    for p in range(NN):
        cross = sum(st[q] == me for q in NBR[p])
        diag = sum(st[q] == me for q in _DIAG[p])
        out[p] = cross >= CROSS_NEED[p] and diag >= DIAG_NEED[p]
    return out


def scoring_mask(board: Board, ana=None) -> np.ndarray:
    """bool[362]: the ScoringSearch candidates: legal points that are no
    Benson eye of either colour and fill no own heuristic eye; never
    pass."""
    ana = ana or board.analysis()
    legal = standard_mask(board, ana)
    _, eye_b, _, eye_w = life(board, ana)
    out = np.zeros(NN + 1, bool)
    out[:NN] = legal[:NN] & ~eye_b & ~eye_w & ~eye_heuristic(board)
    return out


def v1_planes(board: Board, ana=None) -> np.ndarray:
    """float32[361, 32], point-major, dream-go's V1 planes
    (`features.rs:104-148`): 0/1 the komi plane for black/white to move,
    2 any super-ko move, 3/4 the last two moves, 5-10 own chain liberties
    >= 1..6, 11-16 own liberties after a move >= 1..6, 17-22 and 23-28 the
    same for the opponent, 29 the super-ko points, 30/31 ladders (zero:
    the configurations run without ladder planes)."""
    ana = ana or board.analysis()
    chain_of, libs, _ = ana
    me = board.to_move
    opp = 3 - me
    st = np.asarray(board.stones)
    point_libs = np.array([len(libs[chain_of[p]]) if st[p] != EMPTY else 0
                           for p in range(NN)])
    own = np.where(st == me, point_libs, 0)
    their = np.where(st == opp, point_libs, 0)
    _, after_me, repeat = board.point_info(me, ana)
    _, after_opp, _ = board.point_info(opp, ana)
    f32 = np.float32
    komi = np.clip(f32(0.5) + f32(0.5) * f32(board.komi) / f32(7.5),
                   f32(0.0), f32(1.0))
    out = np.zeros((NN, 32), f32)
    out[:, 0] = komi if me == BLACK else 0.0
    out[:, 1] = komi if me != BLACK else 0.0
    out[:, 2] = float(repeat.any())
    for plane, p in ((3, board.last_two[0]), (4, board.last_two[1])):
        if p < NN:
            out[p, plane] = 1.0
    for k in range(1, 7):
        out[:, 4 + k] = own >= k
        out[:, 10 + k] = after_me >= k
        out[:, 16 + k] = their >= k
        out[:, 22 + k] = after_opp >= k
    out[:, 29] = repeat
    return out


def replay(moves, komi: float = 7.5, history_len: int = 64) -> Board:
    """The board after ``moves`` from the empty board."""
    board = Board(komi, history_len)
    for m in moves:
        board.play(int(m))
    return board
