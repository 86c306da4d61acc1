"""The lane-batched form of ``jax.lax.while_loop`` under ``vmap``.

Under ``vmap`` a while loop runs while any lane's condition holds; a lane
whose condition fails keeps its state from then on, and its iteration
count stops.  :func:`while_loop` does the same on tensors whose leading
dims are the lanes, with a per-lane ``active`` mask.  The iterations run
past the last lane's exit are masked on every lane (``cond`` reads only
the state, so a stopped lane stays stopped), so the result does not
depend on when the loop stops.

Run eagerly, whether any lane is still active is a host read, taken every
:data:`CHECK_EVERY` iterations.  Under a CUDA graph capture a host read is
illegal, and the card's PyTorch (2.11) has no conditional graph node to
stop on the device, so a captured loop runs all ``max_iters``
iterations, masked: the same bits and iteration counts, at the price of
the iterations past the last lane's exit.
"""
from __future__ import annotations

import torch

#: Iterations between the host reads of "is any lane still active".
CHECK_EVERY = 4


def _lanes(mask, t):
    return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))


def _capturing(t: torch.Tensor) -> bool:
    """Whether ``t``'s work is being captured into a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def while_loop(cond, body, state, max_iters: int):
    """Run ``state = body(state)`` on each lane while ``cond(state)`` holds
    for it, at most ``max_iters`` times.

    ``state`` is a tuple of tensors whose leading dims are the lanes;
    ``cond(state)`` gives a bool tensor of the lane shape.  Returns the
    final state and each lane's iteration count (int32).
    """
    active = cond(state)
    iters = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    capturing = _capturing(active)
    for it in range(max_iters):
        if not capturing and it % CHECK_EVERY == 0 and not bool(active.any()):
            break
        new = body(state)
        state = tuple(torch.where(_lanes(active, n), n, o) for n, o in zip(new, state))
        iters = iters + active.to(torch.int32)
        active = cond(state)
    return state, iters
