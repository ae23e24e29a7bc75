"""Ranks, the ``(data, model)`` mesh and the learner's collectives (port
of `dream_go_tpu/parallel/`)."""

from .mesh import Mesh, make_mesh, param_sharding  # noqa: F401
