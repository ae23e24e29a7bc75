"""The port's user-facing tools (port of the JAX package's ``tools/``):
``python -m dream_go_torch.tools.<name> --help``."""
