"""Fixtures of the benchmark's own tests: the card, where there is one,
decided inside the fixture, and the cells cut to sizes the CPU holds."""

from __future__ import annotations

import pytest
import torch

# several test workers share the machine's cores
torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; none is present")
    return "cuda"
