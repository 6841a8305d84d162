"""Chunked loop-with-save (port of ``ode_uncertainty_tpu/utils/scan.py``):
run a step function num_steps times, keeping every ``save_every``-th state
plus the initial one."""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


def scan_save(step_fn, state0, num_steps: int, save_every: int = 1):
    """Runs ``state = step_fn(state, idx)`` for idx in [0, num_steps) and
    returns (final_state, trajectory) where trajectory stacks the initial
    state and every save_every-th state along a new leading axis.

    Only ``num_steps // save_every * save_every`` steps are executed (the
    trailing partial chunk would never be saved), as in the JAX package.
    """
    chunks = num_steps // save_every
    saved = [tree_flatten(state0)[0]]
    state = state0
    for chunk_idx in range(chunks):
        for i in range(save_every):
            state = step_fn(state, chunk_idx * save_every + i)
        saved.append(tree_flatten(state)[0])
    spec = tree_flatten(state0)[1]
    stacked = [torch.stack([leaves[i] for leaves in saved]) for i in range(len(saved[0]))]
    return state, tree_unflatten(stacked, spec)
