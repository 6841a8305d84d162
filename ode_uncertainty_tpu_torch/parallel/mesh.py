"""Restart sharding over several devices (port of
``ode_uncertainty_tpu/parallel/mesh.py``).

The estimation workload is embarrassingly parallel over restarts, each a
small state of its own, so scaling out means laying the restart axis over
devices: a 1-D mesh, the leading axis of the restart batch split into
contiguous shards, one per device, the objective's data copied once to
every device, and nothing crossing devices until the results are gathered.

The reference expresses this as a ``NamedSharding`` over a
``jax.sharding.Mesh`` and lets XLA partition one vmapped program. Here one
process drives a list of ``torch.device``s: each shard has its own
objective (built once per device by the caller's factory), its own CUDA
stream, and is launched before any shard is read back, so the devices run
at the same time. The objectives close over device tensors (a :class:`Rig`
or the NLL kernels' wrapper), so every sharded builder here takes ``nll``
as a factory: ``nll(device)`` returns the batched objective
``(p [B, P], q_sqrt, gamma_sqrt) -> [B]`` on that device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ode_uncertainty_tpu_torch.inference.estimate import EstimationResult, make_tempered_estimator
from ode_uncertainty_tpu_torch.inference.lbfgs import value_and_grad

RESTART_AXIS = "restarts"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the device of each shard, in shard order, and the axis
    name. A device may repeat: its shards then share its copy of the data
    and run on streams of their own."""

    devices: Tuple[torch.device, ...]
    axis_name: str = RESTART_AXIS

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def device_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the restart axis: every visible card, the first
    ``num_devices`` of them, or the given ``devices``.

    ``devices`` may repeat a device. A list of eight ``torch.device("cpu")``
    is the counterpart of the reference's eight virtual host devices, and
    ``[cuda:0] * 4`` lays four shards on one card: these test the sharding
    logic on a machine with fewer devices; they do not make it faster than
    the devices it has.
    """
    if devices is None:
        found = torch.cuda.device_count()
        want = found if num_devices is None else int(num_devices)
        if want < 1 or want > found:
            raise ValueError(f"asked for {want} CUDA devices, found {found}; pass devices=[...] for another mesh")
        devices = [f"cuda:{i}" for i in range(want)]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)


def _tree_map(fn, tree):
    """``fn`` on every tensor and numpy array of ``tree`` (tuples, lists,
    dicts, named tuples, frozen dataclasses); other leaves as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = {f.name: _tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init}
        return dataclasses.replace(tree, **fields)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


@dataclasses.dataclass(frozen=True)
class RestartSharding:
    """Placement of arrays whose leading axis is the restart batch: called
    on a tree, returns one tree per shard, shard k on device k."""

    mesh: Mesh

    def __call__(self, tree) -> list:
        n = len(self.mesh)
        for leaf in _leaves(tree):
            if leaf.shape[0] % n:
                raise ValueError(f"the restart axis ({leaf.shape[0]}) must divide evenly over the mesh ({n} devices)")
        return [_tree_map(lambda a, k=k, dev=dev: _rows(a, k, n).to(dev), tree)
                for k, dev in enumerate(self.mesh.devices)]


def _rows(a, k: int, n: int) -> torch.Tensor:
    size = a.shape[0] // n
    return torch.as_tensor(a[k * size:(k + 1) * size])


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Placement of closed-over data: called on a tree, returns one tree per
    shard, copied once to each distinct device (shards on one device share
    its copy)."""

    mesh: Mesh

    def __call__(self, tree) -> list:
        copies = {dev: _tree_map(lambda a, dev=dev: torch.as_tensor(a).to(dev), tree) for dev in self.mesh.distinct}
        return [copies[dev] for dev in self.mesh.devices]


def restart_sharding(mesh: Mesh) -> RestartSharding:
    """Sharding for arrays whose leading axis is the restart batch."""
    return RestartSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_restarts(tree, mesh: Mesh) -> list:
    """Places a tree of [R, ...] arrays restart-sharded on the mesh: one tree
    per shard, each with R / len(mesh) contiguous rows, on its device."""
    return restart_sharding(mesh)(tree)


class _Shards:
    """Each shard's objective and stream. Objectives are built once per
    distinct device by the factory; each shard on a CUDA device gets a
    stream of its own, so shards on one card may overlap."""

    def __init__(self, nll: Callable, q_sqrt, mesh: Mesh):
        self.mesh = mesh
        built = {dev: nll(dev) for dev in mesh.distinct}
        self.objectives = [built[dev] for dev in mesh.devices]
        self.q_sqrt = replicated(mesh)(q_sqrt)
        self.streams = [torch.cuda.Stream(device=dev) if dev.type == "cuda" else None for dev in mesh.devices]

    def on(self, k: int):
        """Context in which shard k's work runs: its device and its stream."""
        stream = self.streams[k]
        if stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.mesh.devices[k]))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    def objective(self, k: int, gamma_sqrt) -> Callable:
        obj, q = self.objectives[k], self.q_sqrt[k]
        return lambda p: obj(p, q, gamma_sqrt)


def _gamma_sqrt(gamma, dtype) -> torch.Tensor:
    """gamma^1/2 as a CPU scalar: the objectives read it on the host."""
    return torch.sqrt(torch.as_tensor(float(gamma), dtype=dtype))


def make_sharded_value_and_grad(nll: Callable, q_sqrt, mesh: Mesh):
    """``vg(x [R, P] numpy, gamma, dtype) -> (f [R], g [R, P])`` as numpy:
    the objective's value and per-lane gradient with the rows split over
    the mesh. R is padded up to a multiple of the mesh size with copies of
    row 0 and the padding dropped. Every shard's points are copied to its
    device first, then every shard's value and gradient are launched (one
    autograd graph per shard, on the shard's device), and only then are
    they read back, so the devices work at the same time."""
    shards = _Shards(nll, q_sqrt, mesh)
    n = len(mesh)

    def vg(x, gamma, dtype):
        nr = len(x)
        pad = (-nr) % n
        if pad:
            x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
        gs = _gamma_sqrt(gamma, dtype)
        rows = np.split(np.asarray(x), n)
        xs = []
        for k, dev in enumerate(mesh.devices):
            with shards.on(k):
                xs.append(torch.as_tensor(rows[k], dtype=dtype, device=dev))
        outs = []
        for k, xk in enumerate(xs):
            with shards.on(k):
                outs.append(value_and_grad(shards.objective(k, gs), xk))
        host = []
        for k, (fk, gk) in enumerate(outs):
            with shards.on(k):
                host.append((fk.cpu().numpy(), gk.cpu().numpy()))
        f = np.concatenate([h[0] for h in host])[:nr]
        g = np.concatenate([h[1] for h in host])[:nr]
        return f, g

    return vg


def make_sharded_tempered_estimator(
    nll: Callable,
    spec,
    q_sqrt,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 1e-6,
    history: int = 10,
):
    """Mesh-sharded variant of
    :func:`ode_uncertainty_tpu_torch.inference.estimate.make_tempered_estimator`:
    ``estimate(p0_norm [R, P_opt], gammas [S]) -> EstimationResult`` with the
    restarts in their original order. R must divide evenly over the mesh.

    One worker thread per shard runs the unsharded estimator on its
    device and stream, from its rows of ``p0_norm``, over every stage (CUDA
    waits release the interpreter lock, so the devices run at the same
    time; on a mesh of CPU devices the shards run one after another in the
    caller's thread); the shards' results are gathered in restart order. Each lane
    keeps its own evaluation count, history and stall counter, as in the
    unsharded estimator. The reference's all-device ``while`` loop makes
    every device step until the slowest lane anywhere is done (its
    docstring's warning); that is how XLA partitions the loop, not what
    the function computes, and here each shard stops when its own lanes do.
    ``spec`` and ``q_sqrt`` are copied once to each device.
    """
    shards = _Shards(nll, q_sqrt, mesh)
    specs = replicated(mesh)(spec)

    def estimate(p0_norm, gammas) -> EstimationResult:
        p0 = torch.as_tensor(p0_norm)
        gam = torch.as_tensor(gammas).cpu()
        rows = shard_restarts(p0, mesh)

        def run(k: int) -> EstimationResult:
            with shards.on(k):
                obj, q = shards.objectives[k], shards.q_sqrt[k]
                est = make_tempered_estimator(lambda p, gs: obj(p, q, gs), specs[k], max_iter=max_iter, tol=tol,
                                              history=history)
                return est(rows[k], gam)

        if any(dev.type == "cuda" for dev in mesh.devices):
            with ThreadPoolExecutor(max_workers=len(mesh)) as pool:
                parts = [fut.result() for fut in [pool.submit(run, k) for k in range(len(mesh))]]
        else:
            # CPU shards gain nothing from threads: their many small
            # operations would only contend for the interpreter lock
            parts = [run(k) for k in range(len(mesh))]
        return EstimationResult(
            *(np.concatenate([getattr(r, f) for r in parts]) for f in EstimationResult._fields[:-1]),
            gammas=parts[0].gammas,
        )

    return estimate


def make_sharded_nll_landscape(nll: Callable, q_sqrt, mesh: Mesh):
    """Mesh-sharded variant of
    :func:`ode_uncertainty_tpu_torch.inference.estimate.make_nll_landscape`:
    ``run(grid [G, P], gammas [S]) -> [S, G]`` (a CPU tensor) with the grid
    axis laid over the mesh (G must be a multiple of the mesh size: pad with
    a repeated row and discard). Every shard's evaluations at every stage
    are launched before any is read back.
    """
    shards = _Shards(nll, q_sqrt, mesh)

    def run(grid, gammas) -> torch.Tensor:
        grid_t = torch.as_tensor(grid)
        parts = shard_restarts(grid_t, mesh)
        gam = torch.as_tensor(gammas).cpu().tolist()
        rows: List[torch.Tensor] = []
        for k, part in enumerate(parts):
            with shards.on(k):
                rows.append(torch.stack([shards.objective(k, _gamma_sqrt(g, grid_t.dtype))(part) for g in gam]))
        host = []
        for k, r in enumerate(rows):
            with shards.on(k):
                host.append(r.cpu())
        return torch.cat(host, dim=1)

    return run
