"""GTP serving: the engine state machine, pondering and the stdin loop."""

from .engine import GtpEngine  # noqa: F401
from .server import run_server  # noqa: F401
