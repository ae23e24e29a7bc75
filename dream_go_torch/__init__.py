"""PyTorch/CUDA port of dream_go_tpu.

A second package beside the JAX one: the same Go engine, search and
self-play, written against PyTorch tensors, with the TPU's Pallas kernels
replaced by kernels written by hand for NVIDIA Hopper (``csrc/``).  Every
entry point takes an explicit ``device`` and runs on ``cuda`` unless the
caller asks for ``cpu``.
"""

__version__ = "0.1.0"
