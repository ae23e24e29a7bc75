"""GTP engine state machine, transport-agnostic (port of
`dream_go_tpu/gtp/engine.py`).

Replaces `src/dg/gtp/mod.rs:157-420`: the 24 reference commands, among
them kgs-genmove_cleanup (ScoringSearch), reg_genmove, the gomill
extensions, undo, loadsgf, final_score and final_status_list.
``GtpEngine.handle(line)`` returns the response; the stdin loop is
`server.py`.

The board history is a list of one-board ``GoState`` batches on the
engine's device.  Every genmove runs the batched search at B=1 for the
rollout budget (a time budget from ``time_settings`` scales it, through
the measured simulation rate, onto a few quantized sizes); the move is the
LCB-greedy best, and plain ``genmove`` resigns below a 10% win rate
(`gtp/mod.rs:389-392`).  With ``ponder=True`` a background thread keeps
searching between commands (`ponder.py`); genmove continues the pondered
tree when it is still the position asked for.

Random draws (the root's Dirichlet noise) come from a ``torch.Generator``
on the engine's device, seeded from ``(seed, genmove count)``, or from the
wall clock when ``seed < 0``; its streams differ from the JAX package's
``fold_in(PRNGKey(seed), count)``, so the two engines agree move for move
only with the noise off.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..config import SearchConfig
from ..go import benson as bn
from ..go import engine as go
from ..mcts import predictor as P
from ..mcts import search as S
from ..selfplay.greedy import greedy_rollout
from ..utils import coords, sgf
from .time_settings import TimeSettings

NAME = "dream_go_torch"
_VERSION = "0.1.0"


class GtpEngine:
    def __init__(self, predictor: P.Predictor | None = None,
                 search_cfg: SearchConfig | None = None,
                 num_rollout: int = 800, ponder: bool = False,
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.predictor = predictor or P.random_predictor()
        self.search_cfg = (search_cfg or SearchConfig()).resolve_auto(
            self.device)
        self.num_rollout = num_rollout
        # seed >= 0: per-move generators seeded from (seed, count), so a
        # game replays identically; seed < 0: wall-clock seeds
        self.seed = seed
        self._genmove_count = 0
        self.komi = 7.5
        self.history: list[go.GoState] = [self._new_state()]
        self.time_settings = TimeSettings()
        self.cpu_time = 0.0
        self.last_explain = ""
        # one key per distinct search (rollouts, cleanup, capacity; the
        # UNST-N extensions; continued ponder trees): a timed game should
        # need only a few
        self._search_keys: set = set()
        # best_move runs at temperature 0: its generator is never read
        self._best_gen = torch.Generator(device=self.device).manual_seed(1)
        # measured simulation rate (sims/s) for time budgeting; starts at a
        # conservative floor and follows real searches after each key's
        # first call
        self._sims_per_sec = 500.0
        self._warmed_keys: set = set()
        self.ponder = None
        if ponder:
            from .ponder import PonderService
            self.ponder = PonderService(self.predictor, self.search_cfg)

    # -- board manipulation --------------------------------------------------

    def _new_state(self) -> go.GoState:
        return go.new_states(1, self.komi, device=self.device)

    @property
    def state(self) -> go.GoState:
        return self.history[-1]

    def _to_move(self, state: go.GoState, color: int) -> go.GoState:
        return state.replace(to_move=torch.full_like(state.to_move, color))

    def _clear(self):
        self.history = [self._new_state()]
        self.last_explain = ""

    def _play(self, color: int, point: int) -> bool:
        state = self._to_move(self.state, color)
        if point != coords.PASS and not bool(go.legal_mask(state)[0, point]):
            return False
        action = torch.full((1,), point, dtype=torch.int32,
                            device=self.device)
        self.history.append(go.step(state, action))
        return True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- search --------------------------------------------------------------

    # sim counts are quantized to a few buckets, so the time budget's
    # jitter maps onto a few distinct searches
    _SIM_BUCKETS = (16, 32, 64, 128, 256, 400, 800, 1600, 3200, 6400)

    def _quantize_sims(self, sims: int) -> int:
        best = self._SIM_BUCKETS[0]
        for b in self._SIM_BUCKETS:
            if b <= sims:
                best = b
        return best

    def _move_number(self) -> int:
        return int(self.state.move_count[0])

    def _sims_for_budget(self, color: int) -> int:
        budget = self.time_settings.budget(color, self._move_number())
        if budget == float("inf"):
            return self.num_rollout
        fitting = int(budget * self._sims_per_sec)
        return self._quantize_sims(max(16, min(self.num_rollout, fitting)))

    def _record_rate(self, key, sims: int, seconds: float):
        """Update the sims/s EWMA, skipping the first call of each key."""
        if key not in self._warmed_keys:
            self._warmed_keys.add(key)
            return
        if seconds <= 0:
            return
        rate = sims / seconds
        self._sims_per_sec = 0.7 * self._sims_per_sec + 0.3 * rate

    def _scoring(self, cleanup: bool):
        return torch.ones(1, dtype=torch.bool, device=self.device) \
            if cleanup else None

    def _maybe_extend(self, trees, color: int, sims: int, cleanup: bool):
        """UNST-N search extensions (`time_control/byo_yomi.rs:106-148`):
        while time-managed, the most visited root child is not the best
        one, and fewer than two extensions were taken, search on (the
        reference multiplies the period by 1.75; here 0.75 * sims more)."""
        if self.time_settings.budget(
                color, self._move_number()) == float("inf"):
            return trees
        ext = max(16, int(0.75 * sims))
        for _ in range(2):
            if not bool(S.search_unstable(trees)[0]):
                break
            self._search_keys.add(("unst", ext, cleanup))
            trees = S.run_search(trees, self.predictor, self.search_cfg,
                                 ext, self._scoring(cleanup))
        return trees

    def _generator(self) -> torch.Generator:
        if self.seed >= 0:
            s = ((self.seed << 32) + self._genmove_count) % (2 ** 63)
        else:
            s = int(_time.time() * 1e3) % (2 ** 31)
        self._genmove_count += 1
        return torch.Generator(device=self.device).manual_seed(s)

    def _genmove(self, color: int, cleanup: bool) -> tuple[int, float]:
        t0 = _time.time()
        state = self._to_move(self.state, color)
        sims = self._sims_for_budget(color)
        pondered = self.ponder.take(state) if self.ponder else None
        if pondered is not None and not cleanup:
            key = ("cont", sims)
            self._search_keys.add(key)
            ts = _time.time()
            trees = S.run_search(pondered, self.predictor, self.search_cfg,
                                 sims, None)
            self._sync()
            self._record_rate(key, sims, _time.time() - ts)
        else:
            # time-managed searches reserve head-room for UNST-N extensions
            timed = self.time_settings.budget(
                color, self._move_number()) != float("inf")
            capacity = sims + 1 + (2 * max(16, int(0.75 * sims)) if timed
                                   else 0)
            key = (sims, cleanup, capacity)
            self._search_keys.add(key)
            ts = _time.time()
            trees = S.search(state, self.predictor, self._generator(),
                             self.search_cfg, sims, self._scoring(cleanup),
                             capacity=capacity)
            self._sync()
            self._record_rate(key, sims, _time.time() - ts)
        trees = self._maybe_extend(trees, color, sims, cleanup)
        move, value = S.best_move(
            trees, self._best_gen, self.search_cfg,
            torch.zeros(1, device=self.device))
        move, value = int(move[0]), float(value[0])
        visits = S.root_visits(trees)[0].cpu().numpy()
        q = S.root_q(trees)[0].cpu().numpy()
        top = np.argsort(-visits)[:5]
        self.last_explain = " ".join(
            f"{coords.to_gtp(int(i))}:{int(visits[i])}({q[i]:.2f})"
            for i in top if visits[i] > 0)
        self.cpu_time += _time.time() - t0
        return move, value

    # -- scoring -------------------------------------------------------------

    def _status(self):
        state = self.state
        finished = greedy_rollout(
            state, self.predictor, max_moves=722,
            ladder_features=self.search_cfg.ladder_features,
            ladders_exact=self.search_cfg.ladders_exact)
        status, terr = bn.stone_status(state.stones, state.chain_id,
                                       finished.stones, finished.chain_id)
        return status[0].cpu().numpy(), terr[0].cpu().numpy()

    def _final_score(self) -> str:
        _, terr = self._status()
        black = float((terr == 1).sum())
        white = float((terr == 2).sum()) + self.komi
        if black > white:
            return f"B+{black - white:.1f}"
        if white > black:
            return f"W+{white - black:.1f}"
        return "0"

    # -- command dispatch ----------------------------------------------------

    def handle(self, line: str) -> tuple[str, bool]:
        """Returns (response line incl. =/? prefix, should_quit)."""
        line = line.split("#")[0].strip()
        if not line:
            return "", False
        parts = line.split()
        ident = ""
        if parts[0].isdigit():
            ident = parts[0]
            parts = parts[1:]
        if not parts:
            return f"?{ident} syntax error", False
        cmd, args = parts[0].lower(), parts[1:]

        try:
            quit_, msg = self._dispatch(cmd, args)
            if self.ponder and cmd in ("play", "genmove",
                                       "kgs-genmove_cleanup", "clear_board",
                                       "undo", "loadsgf"):
                self.ponder.start(self.state)
            if self.ponder and quit_:
                self.ponder.stop()
            return f"={ident} {msg}".rstrip() + "\n", quit_
        except Exception as exc:  # noqa: BLE001 - GTP reports all errors
            return f"?{ident} {exc}\n", False

    KNOWN = [
        "protocol_version", "name", "version", "gomill-describe_engine",
        "gomill-cpu_time", "boardsize", "clear_board", "komi", "play",
        "list_commands", "known_command", "showboard", "genmove",
        "reg_genmove", "kgs-genmove_cleanup", "gomill-explain_last_move",
        "undo", "time_settings", "kgs-time_settings", "time_left", "quit",
        "final_score", "final_status_list", "loadsgf",
    ]

    def _dispatch(self, cmd: str, args: list[str]) -> tuple[bool, str]:
        if cmd == "protocol_version":
            return False, "2"
        if cmd == "name":
            return False, NAME
        if cmd == "version":
            return False, _VERSION
        if cmd == "gomill-describe_engine":
            return False, f"{NAME} {_VERSION} (PyTorch)"
        if cmd == "gomill-cpu_time":
            return False, f"{self.cpu_time:.4f}"
        if cmd == "gomill-explain_last_move":
            return False, self.last_explain
        if cmd == "list_commands":
            return False, "\n".join(self.KNOWN)
        if cmd == "known_command":
            return False, "true" if args and args[0] in self.KNOWN else "false"
        if cmd == "quit":
            return True, ""
        if cmd == "boardsize":
            if args and int(args[0]) != 19:
                raise ValueError("unacceptable size")
            return False, ""
        if cmd == "clear_board":
            self._clear()
            return False, ""
        if cmd == "komi":
            self.komi = float(args[0])
            self.history = [st.replace(komi=torch.full_like(st.komi,
                                                            self.komi))
                            for st in self.history]
            return False, ""
        if cmd == "play":
            color = 1 if args[0].lower().startswith("b") else 2
            point = coords.from_gtp(args[1])
            if not self._play(color, point):
                raise ValueError("illegal move")
            return False, ""
        if cmd == "undo":
            if len(self.history) <= 1:
                raise ValueError("cannot undo")
            self.history.pop()
            return False, ""
        if cmd == "showboard":
            return False, "\n" + self._render_board()
        if cmd in ("genmove", "reg_genmove", "kgs-genmove_cleanup"):
            color = 1 if args[0].lower().startswith("b") else 2
            move, value = self._genmove(color, cmd == "kgs-genmove_cleanup")
            if value < 0.1 and cmd == "genmove":  # gtp/mod.rs:389-392
                return False, "resign"
            vertex = coords.to_gtp(move)
            if cmd != "reg_genmove":
                self._play(color, move)
            return False, vertex
        if cmd == "final_score":
            return False, self._final_score()
        if cmd == "final_status_list":
            return False, self._final_status_list(args[0] if args else "alive")
        if cmd == "time_settings":
            main, byo, stones = (float(args[0]), float(args[1]),
                                 int(args[2]))
            if byo > 0 and stones > 0:
                self.time_settings.set_canadian(main, byo, stones)
            elif stones == 0 and byo > 0:
                self.time_settings.set_none()
            else:
                self.time_settings.set_absolute(main)
            return False, ""
        if cmd == "kgs-time_settings":
            kind = args[0]
            if kind == "none":
                self.time_settings.set_none()
            elif kind == "absolute":
                self.time_settings.set_absolute(float(args[1]))
            elif kind == "canadian":
                self.time_settings.set_canadian(float(args[1]),
                                               float(args[2]), int(args[3]))
            elif kind == "byoyomi":
                self.time_settings.set_byo_yomi(float(args[1]),
                                               float(args[2]), int(args[3]))
            else:
                raise ValueError("unknown time system")
            return False, ""
        if cmd == "time_left":
            color = 1 if args[0].lower().startswith("b") else 2
            self.time_settings.time_left(color, float(args[1]), int(args[2]))
            return False, ""
        if cmd == "loadsgf":
            return False, self._loadsgf(args)
        raise ValueError("unknown command")

    def _final_status_list(self, which: str) -> str:
        status, terr = self._status()
        stones = self.state.stones[0].cpu().numpy()
        sel = {
            "alive": status == bn.STATUS_ALIVE,
            "dead": status == bn.STATUS_DEAD,
            "seki": status == bn.STATUS_SEKI,
            "black_territory": terr == 1,
            "white_territory": terr == 2,
        }.get(which)
        if sel is None:
            raise ValueError("unknown status")
        if which in ("alive", "dead", "seki"):
            sel = sel & (stones != 0)
        return " ".join(coords.to_gtp(int(p)) for p in np.flatnonzero(sel))

    def _loadsgf(self, args: list[str]) -> str:
        path = args[0]
        max_moves = int(args[1]) if len(args) > 1 else 10**9
        with open(path) as fh:
            game = sgf.parse_line(fh.read().replace("\n", ""))
        if game is None:
            raise ValueError("cannot load file")
        self.komi = game.komi
        self._clear()
        for i, mv in enumerate(game.moves):
            if i >= max_moves:
                break
            self._play(mv.color, mv.point)
        return ""

    def _render_board(self) -> str:
        stones = self.state.stones[0].cpu().numpy().reshape(19, 19)
        lines = []
        for y in range(19):
            row = " ".join(".XO"[c] for c in stones[y])
            lines.append(f"{19 - y:2d} {row}")
        lines.append("   " + " ".join("ABCDEFGHJKLMNOPQRST"))
        return "\n".join(lines)
