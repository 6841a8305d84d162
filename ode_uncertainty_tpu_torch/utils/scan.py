"""Chunked loop-with-save (port of ``ode_uncertainty_tpu/utils/scan.py``):
run a step function num_steps times, keeping every ``save_every``-th state
plus the initial one.

:func:`scan_save` runs the steps eagerly. :func:`scan_plan` runs steps of a
few kinds (a predict, a predict and a correct, ...) fed with per-step data;
on CUDA tensors it captures each kind once as a CUDA graph that updates a
static copy of the state in place, and replays it, so a step costs one
launch from the host instead of one per operation (hundreds for a filter
step). The graph replays the operations the eager step runs, on the same
device, so both give the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch


def scan_save(step_fn, state0, num_steps: int, save_every: int = 1):
    """Runs ``state = step_fn(state, idx)`` for idx in [0, num_steps) and
    returns (final_state, trajectory) where trajectory stacks the initial
    state and every save_every-th state along a new leading axis. The state
    is a tensor, or a (nested) tuple, list or dataclass of tensors (the
    filter states).

    Only ``num_steps // save_every * save_every`` steps are executed (the
    trailing partial chunk would never be saved), as in the JAX package.
    """
    return scan_plan(lambda s, kind, idx: step_fn(s, int(idx)), lambda idx: (None, (idx,)), state0, num_steps,
                     save_every, graphs=False)


def _flatten(state) -> Tuple[List[torch.Tensor], Callable]:
    """Leaves of a (nested) tuple/list/dataclass of tensors and a rebuild."""
    if dataclasses.is_dataclass(state):
        names = [f.name for f in dataclasses.fields(state)]
        leaves, rebuild = _flatten(tuple(getattr(state, k) for k in names))
        return leaves, lambda ls: dataclasses.replace(state, **dict(zip(names, rebuild(ls))))
    if isinstance(state, (tuple, list)):
        parts = [_flatten(s) for s in state]
        sizes = [len(p[0]) for p in parts]

        def rebuild(ls):
            out, i = [], 0
            for (_, rb), k in zip(parts, sizes):
                out.append(rb(ls[i:i + k]))
                i += k
            return type(state)(out)

        return [leaf for p in parts for leaf in p[0]], rebuild
    return [state], lambda ls: ls[0]


class _StepGraph:
    """One step of ``step_fn(state, kind, *data)`` captured as a CUDA graph
    over the static state ``leaves`` (updated in place) and static data."""

    def __init__(self, step_fn, kind, leaves, rebuild, data, pool):
        self.data = [d.clone() for d in data]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up (library handles, workspaces)
            step_fn(rebuild(leaves), kind, *self.data)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            out, _ = _flatten(step_fn(rebuild(leaves), kind, *self.data))
            for leaf, new in zip(leaves, out):
                leaf.copy_(new)

    def __call__(self, data):
        for buf, d in zip(self.data, data):
            buf.copy_(d)
        self.graph.replay()


def scan_plan(step_fn, plan, state0, num_steps: int, save_every: int = 1, graphs: bool = True):
    """Runs ``state = step_fn(state, kind, *data)`` with ``(kind, data) =
    plan(idx)`` for idx in [0, num_steps // save_every * save_every) and
    returns (final_state, trajectory) as :func:`scan_save` does. ``data`` is
    a tuple of tensors (the step's observation, say) and ``kind`` a hashable
    label of the step's control flow.

    With ``graphs`` and a state on a CUDA device, each kind runs as a replay
    of its CUDA graph (captured at its first step); ``step_fn`` must then be
    capturable: no host synchronization and no host-to-device copy.
    """
    leaves0, rebuild = _flatten(state0)
    graphed = graphs and leaves0[0].is_cuda
    if graphed:
        leaves = [leaf.clone() for leaf in leaves0]
        pool = torch.cuda.graph_pool_handle()
        step_graphs: Dict[object, _StepGraph] = {}
    state = state0
    saved = [leaves0]
    for chunk in range(num_steps // save_every):
        for i in range(save_every):
            kind, data = plan(chunk * save_every + i)
            if graphed:
                if kind not in step_graphs:
                    step_graphs[kind] = _StepGraph(step_fn, kind, leaves, rebuild, data, pool)
                step_graphs[kind](data)
            else:
                state = step_fn(state, kind, *data)
        saved.append([leaf.clone() for leaf in leaves] if graphed else _flatten(state)[0])
    stacked = [torch.stack([ls[i] for ls in saved]) for i in range(len(leaves0))]
    return rebuild(saved[-1]), rebuild(stacked)
