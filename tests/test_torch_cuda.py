"""The port's CUDA kernels on the card, against their plain versions.

This module imports no JAX (the machine with the card has none), so it
runs there without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test skips.
"""

import pytest
import torch

from dream_go_torch.go import engine
from dream_go_torch.ops import layout
from dream_go_torch.ops import leaf_step as L

P = lambda x, y: 19 * y + x
#: black captures at (2,1); white's recapture at (1,1) is a super-ko
KO_MOVES = [P(1, 0), P(2, 0), P(0, 1), P(3, 1), P(1, 2), P(2, 2), P(10, 10),
            P(1, 1)]
KO_ACTION = P(2, 1)


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
        assert float(got[1][0, 29, P(1, 1)]) == 1.0   # the ko


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
