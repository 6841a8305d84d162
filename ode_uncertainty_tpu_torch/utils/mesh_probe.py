"""Weak scaling of restart sharding on a kernel-bound rig: for n = 1, 2, 4
cards, n x ``--per-card`` restarts through one tempering stage of the host
L-BFGS (``make_stage_optimizer_host(mesh=...)``) and of the device
L-BFGS's tempered estimator (``make_sharded_tempered_estimator``), on the
first n cards and, beside it, unsharded on one card; the two held bit for
bit. The experiment runs through the NLL kernels (default
params/hodgkinhuxley1_r4: Kvaerno3, 10^4 steps, float32, its first
tempering stage, ``--lbfgs-maxiter`` iterations). One JSON line per run:
the path, the cards, the restarts, the wall seconds, the objective's calls
(one per shard and dispatch) and, for a sharded run, the one-card run's
wall seconds over its own and, where the two differ, which lanes. Before
them, a check of the kernels themselves: every restart's value and
gradient in one launch on cuda:0 against a second such launch and against
the shards' launches on their cards and on cuda:0. Bit for bit: the same
bits, a NaN in the same place on both sides included.

The LV cells of chip_smoke.py are host-bound (a dispatch there is ~2 ms of
kernels and a few ms of host work per shard); this probe asks whether one
process keeps several cards busy when the kernels dominate. A kernel of
this rig takes as long for 1 lane as for a few hundred (latency-bound), so
one card running every restart is the alternative a mesh has to beat.

Usage (on the card):
  python ode_uncertainty_tpu_torch/utils/mesh_probe.py [--experiment params/hodgkinhuxley1_r4]
      [--data hodgkinhuxley_r4.npz] [--per-card 100] [--lbfgs-maxiter 4] [--devices 1,2,4]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from ode_uncertainty_tpu_torch.inference import make_stage_optimizer_host, make_tempered_estimator  # noqa: E402
from ode_uncertainty_tpu_torch.parallel import (  # noqa: E402
    device_mesh,
    make_sharded_tempered_estimator,
)
from ode_uncertainty_tpu_torch.run_parameter_estimation import (  # noqa: E402
    batched_nll,
    build_rig,
    gammas_of,
    initial_restarts,
)
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment  # noqa: E402

DATA = Path(__file__).resolve().parents[1] / "data"


class Objective:
    """A factory for the sharded builders: the NLL kernels' wrapper of
    ``cfg`` (float32) on each device asked for, recording the width of every
    call; the shards' calls may come from several threads, hence the lock."""

    def __init__(self, cfg):
        self.cfg, self.widths, self.lock = cfg, [], threading.Lock()

    @property
    def calls(self) -> int:
        return len(self.widths)

    def __call__(self, device):
        rig = build_rig(self.cfg, torch.float32, torch.device(device))
        kern, on_kernels = batched_nll(rig, self.cfg, grad=True)
        if not on_kernels:
            raise ValueError("the experiment is not on the kernels' route")

        def nll(p, q_sqrt, gamma_sqrt):
            with self.lock:
                self.widths.append(p.shape[0])
            return kern(p, gamma_sqrt)

        return nll


def unequal(a, b) -> np.ndarray:
    """Elementwise: the bits differ (a NaN in the same place on both sides is
    equal)."""
    return (a != b) & ~(np.isnan(a) & np.isnan(b))


def same(got, ref, fields) -> bool:
    return all(np.array_equal(getattr(got, f), getattr(ref, f), equal_nan=np.asarray(getattr(ref, f)).dtype.kind == "f")
               for f in fields)


def differences(got, ref, fields) -> dict:
    """Per field: the lanes that differ and the largest absolute difference."""
    out = {}
    for f in fields:
        a, b = np.asarray(getattr(got, f), np.float64), np.asarray(getattr(ref, f), np.float64)
        lanes = np.nonzero(unequal(a, b).reshape(len(a), -1).any(axis=1))[0]
        out[f] = {"lanes_differing": int(len(lanes)), "first": lanes[:8].tolist(),
                  "max_abs_diff": float(np.nanmax(np.abs(a - b))) if a.size else 0.0}
    return out


def kernel_check(cfg, p0, gamma, mesh) -> dict:
    """The forward and gradient kernels on every restart at gamma: one launch
    on cuda:0 against one launch per shard on the shard's card and per shard
    on cuda:0, and a second launch on cuda:0 (is the kernel deterministic?)."""
    gs = float(np.sqrt(gamma))
    shards = torch.chunk(p0, len(mesh))

    def run(dev, p):
        rig = build_rig(cfg, torch.float32, torch.device(dev))
        kern, _ = batched_nll(rig, cfg, grad=True)
        phys = kern.physical(p.to(dev))
        ones = torch.ones(phys.shape[1], device=dev)
        f = kern.launch(phys, gs)
        g, _ = kern.grad.launch(phys, gs, ones, False, kern.opt_rows)
        return torch.cat([f[None], g[list(kern.opt_rows)]]).cpu().numpy()

    whole = run("cuda:0", p0)
    again = run("cuda:0", p0)
    on_cards = np.concatenate([run(dev, p) for dev, p in zip(mesh.devices, shards)], axis=1)
    on_zero = np.concatenate([run("cuda:0", p) for p in shards], axis=1)
    count = lambda a: int(unequal(a, whole).any(axis=0).sum())
    return {"lanes_differing_second_launch": count(again), "lanes_differing_shards_on_their_cards": count(on_cards),
            "lanes_differing_shards_on_cuda0": count(on_zero),
            "max_abs_diff_shards_on_their_cards": float(np.nanmax(np.abs(on_cards - whole)))}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Weak scaling of restart sharding on a kernel-bound rig")
    ap.add_argument("--experiment", default="params/hodgkinhuxley1_r4")
    ap.add_argument("--data", default="hodgkinhuxley_r4.npz")
    ap.add_argument("--per-card", type=int, default=100)
    ap.add_argument("--lbfgs-maxiter", type=int, default=4)
    ap.add_argument("--devices", default="1,2,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mesh_probe needs a CUDA device")

    counts = [int(n) for n in args.devices.split(",") if int(n) <= torch.cuda.device_count()]
    it = args.lbfgs_maxiter
    q = torch.eye(1)
    for n in counts:
        cfg = build_config(load_experiment(args.experiment), {"y_path": str(DATA / args.data), "device": "cuda",
                                                             "num_random_runs": args.per_card * n})
        gamma = float(gammas_of(cfg, torch.float32)[0])
        rig = build_rig(cfg, torch.float32, torch.device("cuda:0"))
        p0 = initial_restarts(cfg, rig.spec, torch.float32).cpu()
        tol = cfg.get("lbfgs_tol", 1e-4)
        base = {"experiment": args.experiment, "steps": rig.num_steps, "gamma": gamma, "lbfgs_maxiter": it,
                "restarts": len(p0), "card": torch.cuda.get_device_name(0)}
        mesh = device_mesh(num_devices=n)
        for dev in mesh.devices:  # each card's context and module, before any clock
            Objective(cfg)(dev)(p0[:1].to(dev), q, torch.tensor(0.0))

        print(json.dumps({**base, "cards": n, "kernel_check": kernel_check(cfg, p0, gamma, mesh)}), flush=True)

        # the host L-BFGS, one stage
        one = Objective(cfg)
        kern = one("cuda:0")
        plain = make_stage_optimizer_host(None, q, nll_batched=lambda p, gs: kern(p, q, gs), max_iter=it, tol=tol,
                                          dtype=torch.float32, progress_every=0)
        ref, ref_s = timed(lambda: plain(p0.to("cuda:0"), gamma))
        obj = Objective(cfg)
        stage = make_stage_optimizer_host(obj, q, max_iter=it, tol=tol, dtype=torch.float32, mesh=mesh,
                                          progress_every=0)
        got, s = timed(lambda: stage(p0.numpy(), gamma))
        fields = ("x", "f", "iters", "n_fev")
        equal = same(got, ref, fields)
        print(json.dumps({**base, "path": "host", "cards": n, "wall_s": s, "calls": obj.calls,
                          "one_card_wall_s": ref_s, "one_card_calls": one.calls, "speedup": ref_s / s,
                          "bit_equal": equal, "nonfinite_f": int((~np.isfinite(ref.f)).sum()),
                          **({} if equal else {"differences": differences(got, ref, fields)})}), flush=True)

        # the device L-BFGS's tempered estimator, the same stage
        gam = torch.tensor([gamma])
        one = Objective(cfg)
        kern = one("cuda:0")
        ref, ref_s = timed(lambda: make_tempered_estimator(lambda p, gs: kern(p, q, gs), rig.spec, max_iter=it,
                                                           tol=tol)(p0.to("cuda:0"), gam))
        obj = Objective(cfg)
        est = make_sharded_tempered_estimator(obj, rig.spec, q, mesh, max_iter=it, tol=tol)
        got, s = timed(lambda: est(p0, gam))
        equal = same(got, ref, got._fields)
        print(json.dumps({**base, "path": "device", "cards": n, "wall_s": s, "calls": obj.calls,
                          "one_card_wall_s": ref_s, "one_card_calls": one.calls, "speedup": ref_s / s,
                          "bit_equal": equal, "nonfinite_f": int((~np.isfinite(ref.nll_optims)).sum()),
                          **({} if equal else {"differences": differences(got, ref, got._fields[:-1])})}), flush=True)


if __name__ == "__main__":
    main()
