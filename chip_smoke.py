"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own wall seconds:

  1. device       nvidia-smi name and power limit; fails without CUDA.
  2. build        nvcc builds csrc/*.cu into build/ (one nvcc per source, in
                  parallel, then a link; timed).
  3. parity       the nll_fwd kernel against its plain PyTorch version on the
                  card, at the full 2000-step horizon, for gamma^1/2 = 0.1 and
                  gamma = 0, on the params/lotkavolterra2 rig (L = 1) and the
                  bench.py LV rig (L = 2): float64 kernel vs float64 plain
                  (rtol 1e-9) and float32 kernel vs float64 plain (p99 of the
                  lane-normalized error |k - p| / (|p| + 1) <= 2e-4). Lanes that
                  are not finite must coincide.
  4. grad parity  the nll_bwd kernel against its plain version (autograd
                  through the plain forward) on 256 lanes, half at gamma^1/2 =
                  0.1 and half at 0, every parameter row and each lane's
                  d/d gamma^1/2: the lotkavolterra2 rig at its full 2000 steps,
                  the bench.py LV rig cut to 600 steps (the plain gradient takes
                  ~45 s per 2000 steps on the card). float64 kernel vs float64
                  plain: max relative error <= 1e-8 (an element whose plain value
                  is 0 relative to the largest); float32 kernel vs float64
                  plain: p99 of the lane-normalized error <= 5e-3 (the gradient
                  rtol of tests/test_pallas_ekf.py), max reported; no
                  non-finite value on either side.
  5. main path    the port's `evaluate` on params/lotkavolterra2 (20 x 20 grid,
                  4 tempering stages, float32) with the launch counts set to 0
                  just before; observations are synthesized (RKF45 solve at the
                  default parameters, one point per step, noise of variance 0.1
                  from numpy's default_rng(seed)). Checks shape, finiteness,
                  launches > 0 and 64 grid points against the float64 plain
                  version.
  6. optimize     the port's `optimize` on params/lotkavolterra2 at full width
                  (100 restarts from a seeded torch.Generator, 4 tempering
                  stages, 2000 steps, float32, lbfgs_maxiter 200) on the same
                  observations, the counts set to 0 just before. Checks that
                  both kernels ran, that >= 95% of restarts end finite, that the
                  best final NLL is at most the NLL at the generating
                  parameters (gamma = 0, same kernel) plus 1e-3 relative, and
                  that the best optimum is within 10% of the generating alpha
                  and beta. Prints each stage's wall time, dispatches and the
                  lanes still active at the iteration limit.
  7. timing       one nll_fwd launch of evaluate's shape and one nll_bwd launch
                  at optimize's widest dispatch, each the median of 7 CUDA-event
                  timings, beside its bound and its plain version's time; the
                  nll_bwd launch also with d/d gamma^1/2 and in float64.
  8. throughput   bench.py's `lv` workload: B = 8192, 2000 steps, H = I,
                  an observation every 10 steps, float32, gamma = 0.01; median
                  of CUDA-event-timed launches; the plain version once at B = 1024.
  9. kernels      one JSON line with the kernel list, the nvidia-smi line,
                  then the device line.

Files too long for the output (the ptxas report, the synthesized
observations, the results) go to chiprun_out/. Any failed check raises, and
the script exits non-zero without printing the last line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ode_uncertainty_tpu_torch import models, solvers
from ode_uncertainty_tpu_torch.filters import SqrtEKF
from ode_uncertainty_tpu_torch.inference import make_obs_model, make_param_spec
from ode_uncertainty_tpu_torch.ops import const_diag
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch.run_parameter_estimation import build_rig, evaluate, optimize
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment
from ode_uncertainty_tpu_torch.utils.cuda_build import build_library

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
DEVICE = "cuda"
SEED = 0
PARITY_LANES = 1024
GRID_CHECK = 64  # main-path grid points also evaluated by the float64 plain version
RTOL_F64 = 1e-9
P99_F32 = 2e-4
GRAD_LANES = 256
GRAD_RTOL_F64 = 1e-8
GRAD_P99_F32 = 5e-3
BENCH_GRAD_STEPS = 600  # the bench rig's horizon in grad parity
# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet): HBM3
# bandwidth, non-tensor float32 and float64 FLOP/s.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase and prints its JSON line on success."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": time.perf_counter() - self.t0, **self.info})
        return False


class OpCounter(TorchDispatchMode):
    """Counts the elementwise arithmetic the plain version does, one
    operation per output element (fused multiply-adds count as two)."""

    ARITH = {"add", "sub", "rsub", "mul", "div", "sqrt", "abs", "maximum", "where",
             "clamp", "log", "neg", "gt", "ge", "lt"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.ARITH and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


def ops_per_lane(cm) -> int:
    """Operations one lane does over the whole horizon: the first interval
    (first + 1 predicts and a correct) plus n_obs - 1 intervals of d."""
    like = torch.zeros(1, dtype=cm.dtype)
    params = {k: like + 1.0 for k in cm.offsets}
    qg = [[like + 0.1 * q for q in row] for row in cm.Q]
    r_const = [[like + r for r in row] for row in cm.R]
    x = [like + v for v in cm.x0]
    p_mat = [[like + v for v in row] for row in cm.p0]
    y = [like for _ in range(cm.L)]
    counts = []
    for count in (cm.first + 1, cm.d):
        with OpCounter() as c:
            cm.interval(x, p_mat, params, qg, r_const, y, count)
        counts.append(c.ops)
    return counts[0] + (cm.n_obs - 1) * counts[1]


def grad_ops_per_lane(cm) -> int:
    """Operations one lane's gradient takes by reverse mode (the plain
    version's forward and backward over the whole horizon): counted on one
    lane for 2 and 3 observations, the rest by the per-interval increment."""
    counts = []
    for n_obs in (2, 3):
        short = dataclasses.replace(cm, n_obs=n_obs)
        phys = torch.ones((cm.k_params, 1), dtype=cm.dtype)
        ys = torch.zeros((n_obs, cm.L), dtype=cm.dtype)
        with OpCounter() as c:
            nll_kernel.nll_grad_plain(short, phys, ys, 0.1, torch.ones(1, dtype=cm.dtype))
        counts.append(c.ops)
    return counts[0] + (cm.n_obs - 2) * (counts[1] - counts[0])


def bound_ms(cm, batch: int, grad: bool = False) -> tuple:
    """Least time for one launch: bytes in and out over HBM bandwidth vs the
    operations over the non-tensor peak of the dtype. The forward reads the
    parameter rows and the observations and writes the NLL; the gradient
    also reads the cotangent and writes the parameter rows' gradient."""
    item = torch.finfo(cm.dtype).bits // 8
    values = cm.k_params * batch + cm.n_obs * cm.L + batch
    if grad:
        values += cm.k_params * batch
    ops = (grad_ops_per_lane(cm) if grad else ops_per_lane(cm)) * batch
    t_bytes = values * item / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[cm.dtype] * 1e3
    return (t_ops, "operations", ops) if t_ops >= t_bytes else (t_bytes, "bytes", ops)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_times(fn, reps: int) -> list:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def synthesize_observations(path: Path) -> dict:
    """RKF45 solve of Lotka-Volterra at its default parameters, one point per
    step over the experiment's horizon, plus N(0, 0.1) noise; written as the
    observation file schema (t [T], x [T, 1, 2])."""
    raw = load_experiment("params/lotkavolterra2")
    h = raw["solver_builder"]["init_args"]["step_size"]
    steps = int(round((raw["tN"] - raw["t0"]) / h))
    sol = solvers.solve(
        solvers.rkf45(h), models.lotka_volterra(), raw["t0"],
        torch.tensor([[1.0, 1.0]], dtype=torch.float64, device=DEVICE), steps,
    )
    x = sol["x"].cpu().numpy()
    noise = np.sqrt(raw["obs_noise_var"]) * np.random.default_rng(SEED).standard_normal(x.shape)
    np.savez(path, t=sol["t"].cpu().numpy(), x=x + noise)
    return {"observations": str(path.relative_to(ROOT)), "points": int(x.shape[0]), "steps": steps,
            "noise_var": raw["obs_noise_var"], "seed": SEED}


def lv2_config(obs_path: Path, out_path: Path):
    return build_config(
        load_experiment("params/lotkavolterra2"),
        {"y_path": str(obs_path), "output": str(out_path), "device": DEVICE},
    )


def bench_lv_kernel(dtype, num_steps=2000, obs_every=10, noise=0.1):
    """bench.py's `lv` rig (bench.py:51-52, 117-137) in the port."""
    m = models.lotka_volterra()
    h = 0.01
    sol = solvers.rkf45(h)
    x0 = torch.tensor([[1.0, 1.0]], dtype=dtype, device=DEVICE)
    gt = solvers.solve(sol, m, 0.0, x0, num_steps)
    idx = np.arange(obs_every, num_steps + 1, obs_every)
    ys = gt["x"].cpu().numpy()[idx].reshape(len(idx), -1)
    ys = ys + np.sqrt(noise) * np.random.default_rng(0).standard_normal(ys.shape)
    obs = make_obs_model(np.eye(2), gt["t"].cpu().numpy()[idx], ys, noise, 0.0, h, num_steps,
                         dtype=dtype, device=DEVICE)
    spec = make_param_spec(m.params, {k: (0.1, 5.0) for k in m.params},
                           {"alpha": True, "beta": True, "gamma": False, "delta": False},
                           dtype=dtype, device=DEVICE)
    ekf = SqrtEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, const_diag(2, 1e-12, dtype, DEVICE), obs.obs_dim)
    q = torch.eye(2, dtype=dtype, device=DEVICE)
    return nll_kernel.make_nll_cuda(m, sol, ekf, spec, obs, state0, num_steps, q)


def lv2_kernel(cfg, dtype):
    rig = build_rig(cfg, dtype, torch.device(DEVICE))
    return nll_kernel.make_nll_cuda(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs,
                                    rig.state0, rig.num_steps, rig.q_sqrt)


def compare(kernel_vals, plain_vals, exact: bool) -> dict:
    k = kernel_vals.double().cpu().numpy()
    p = plain_vals.double().cpu().numpy()
    fin_k, fin_p = np.isfinite(k), np.isfinite(p)
    both = fin_k & fin_p
    if exact:
        err = np.abs(k[both] - p[both]) / np.abs(p[both])
        stat = {"max_rel_err": float(err.max()), "rtol": RTOL_F64}
        ok = stat["max_rel_err"] <= RTOL_F64
    else:
        err = np.abs(k[both] - p[both]) / (np.abs(p[both]) + 1.0)
        stat = {"p99_lane_err": float(np.quantile(err, 0.99)), "max_lane_err": float(err.max()),
                "p99_limit": P99_F32}
        ok = stat["p99_lane_err"] <= P99_F32
    mismatch = int((fin_k != fin_p).sum())
    stat.update(lanes=int(k.size), nonfinite_kernel=int((~fin_k).sum()),
                nonfinite_plain=int((~fin_p).sum()), nonfinite_mismatch=mismatch,
                max_abs_err=float(np.abs(k[both] - p[both]).max()))
    if not ok or mismatch:
        raise AssertionError(f"kernel disagrees with its plain version: {stat}")
    return stat


def parity(name, make, grid_norm=None, grid_gammas=None) -> dict:
    """Kernel (float64 and float32) against the float64 plain version on
    random lanes at gamma^1/2 = 0.1 and gamma = 0 (plus optional grid lanes)."""
    rng = np.random.default_rng(SEED)
    k64, k32 = make(torch.float64), make(torch.float32)
    cols = k64.spec.num_opt
    half = PARITY_LANES // 2 - (0 if grid_norm is None else len(grid_norm))
    groups = []  # (normalized params, gamma_sqrt)
    for g_sqrt, g_grid in ((0.1, None if grid_gammas is None else grid_gammas[0]),
                           (0.0, None if grid_gammas is None else grid_gammas[1])):
        p = rng.uniform(size=(half, cols))
        groups.append((p, g_sqrt))
        if grid_norm is not None:
            groups.append((grid_norm, g_grid))
    p_all = torch.as_tensor(np.concatenate([g[0] for g in groups]), device=DEVICE)
    g_all = torch.as_tensor(np.concatenate([np.full(len(g[0]), g[1]) for g in groups]),
                            dtype=torch.float64, device=DEVICE)
    phys64 = k64.physical(p_all)
    plain64, plain_ms = sync_time(lambda: nll_kernel.nll_plain(k64.cm, phys64, k64.ys, g_all))
    out = {"rig": name, "L": k64.cm.L, "d": k64.cm.d, "n_obs": k64.cm.n_obs,
           "plain_f64_ms": plain_ms}
    for label, kern, exact in (("f64", k64, True), ("f32", k32, False)):
        vals = torch.cat([kern.launch(kern.physical(torch.as_tensor(p, device=DEVICE)), g)
                          for p, g in groups])
        torch.cuda.synchronize()
        out[f"kernel_{label}_vs_plain_f64"] = compare(vals, plain64, exact)
    out["_plain64"] = plain64
    return out


def compare_grads(kernel_vals, plain_vals, exact: bool) -> dict:
    """[K + 1, B] gradients (parameter rows, then each lane's d/d gamma^1/2)
    of the kernel against the float64 plain version."""
    k = kernel_vals.double().cpu().numpy()
    p = plain_vals.double().cpu().numpy()
    stat = {"values": int(k.size), "nonfinite_kernel": int((~np.isfinite(k)).sum()),
            "nonfinite_plain": int((~np.isfinite(p)).sum())}
    if stat["nonfinite_kernel"] or stat["nonfinite_plain"]:
        raise AssertionError(f"non-finite gradients: {stat}")
    diff = np.abs(k - p)
    stat["max_abs_err"] = float(diff.max())
    if exact:
        rel = diff / np.where(p != 0, np.abs(p), np.abs(p).max())
        stat.update(max_rel_err=float(rel.max()), rtol=GRAD_RTOL_F64)
        ok = stat["max_rel_err"] <= GRAD_RTOL_F64
    else:
        err = diff / (np.abs(p) + 1.0)
        stat.update(p99_lane_err=float(np.quantile(err, 0.99)), max_lane_err=float(err.max()),
                    p99_limit=GRAD_P99_F32)
        ok = stat["p99_lane_err"] <= GRAD_P99_F32
    if not ok:
        raise AssertionError(f"nll_bwd disagrees with its plain version: {stat}")
    return stat


def grad_parity(name, make) -> dict:
    """nll_bwd (float64 and float32) against the float64 plain gradient on
    GRAD_LANES random lanes, half at gamma^1/2 = 0.1 and half at 0, with a
    random cotangent."""
    rng = np.random.default_rng(SEED + 1)
    k64, k32 = make(torch.float64), make(torch.float32)
    half = GRAD_LANES // 2
    p = torch.as_tensor(rng.uniform(size=(GRAD_LANES, k64.spec.num_opt)), device=DEVICE)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, size=GRAD_LANES), device=DEVICE)
    gs = torch.as_tensor(np.repeat([0.1, 0.0], half), device=DEVICE)
    phys64 = k64.physical(p)
    (dphys, dgamma), plain_ms = sync_time(lambda: nll_kernel.nll_grad_plain(k64.cm, phys64, k64.ys, gs, g))
    plain = torch.cat([dphys, dgamma[None]])
    out = {"rig": name, "L": k64.cm.L, "d": k64.cm.d, "n_obs": k64.cm.n_obs, "lanes": GRAD_LANES,
           "plain_f64_ms": plain_ms}
    for label, kern, exact in (("f64", k64, True), ("f32", k32, False)):
        parts = [kern.grad.launch(kern.physical(p[sl]), gsv, g[sl])
                 for sl, gsv in ((slice(0, half), 0.1), (slice(half, None), 0.0))]
        got = torch.cat([torch.cat([dp, dg[None]]) for dp, dg in parts], dim=1)
        torch.cuda.synchronize()
        out[f"kernel_{label}_vs_plain_f64"] = compare_grads(got, plain, exact)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    OUT.mkdir(exist_ok=True)

    with Phase("device") as ph:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        ph.info.update(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    with Phase("build") as ph:
        res = build_library()
        (OUT / "nvcc_ptxas.txt").write_text(res.log)
        ph.info.update(nvcc_seconds=res.seconds, built=res.built, library=str(res.path.relative_to(ROOT)),
                       ptxas=[ln.strip() for ln in res.log.splitlines() if "registers" in ln])

    obs_path, out_path = OUT / "lv2_observations.npz", OUT / "lv2_evaluate.npz"
    out_path.unlink(missing_ok=True)
    with Phase("observations") as ph:
        ph.info.update(synthesize_observations(obs_path))

    cfg = lv2_config(obs_path, out_path)
    grid_idx = np.linspace(0, 399, GRID_CHECK).astype(int)
    axes = [np.linspace(0.0, 1.0, 20)] * 2
    grid_norm = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 2)[grid_idx]
    gammas = cfg["gamma_noise_schedule"].gammas(4, True).to(torch.float32)
    grid_gammas = (float(torch.sqrt(gammas[0])), float(torch.sqrt(gammas[-1])))

    with Phase("parity") as ph:
        lv2 = parity("params/lotkavolterra2", lambda dt: lv2_kernel(cfg, dt), grid_norm, grid_gammas)
        plain_grid = lv2.pop("_plain64")
        bench = parity("bench.py lv", bench_lv_kernel)
        bench.pop("_plain64")
        ph.info.update(lotkavolterra2=lv2, bench_lv=bench)

    with Phase("grad_parity") as ph:
        lv2_grad = grad_parity("params/lotkavolterra2", lambda dt: lv2_kernel(cfg, dt))
        bench_grad = grad_parity(f"bench.py lv, {BENCH_GRAD_STEPS} steps",
                                 lambda dt: bench_lv_kernel(dt, num_steps=BENCH_GRAD_STEPS))
        ph.info.update(lotkavolterra2=lv2_grad, bench_lv=bench_grad)

    with Phase("main_path") as ph:
        nll_kernel.reset_launches()
        res = evaluate(cfg)
        counts = dict(nll_kernel.launches)
        vals = res["nll_evals"]
        if vals.shape != (4, 400) or not np.isfinite(vals).all():
            raise AssertionError(f"evaluate gave shape {vals.shape}, finite {np.isfinite(vals).all()}")
        if counts["nll_fwd"] <= 0 or res["route"] != "nll_fwd kernel":
            raise AssertionError(f"main path did not run the kernel: {counts}, {res['route']}")
        # the grid lanes of the parity run: [random | grid] at 0.1, then at 0
        half = PARITY_LANES // 2
        ref = np.concatenate([plain_grid[half - GRID_CHECK:half].cpu().numpy(),
                              plain_grid[PARITY_LANES - GRID_CHECK:].cpu().numpy()])
        got = np.concatenate([vals[0, grid_idx], vals[-1, grid_idx]])
        err = np.abs(got - ref) / (np.abs(ref) + 1.0)
        if np.quantile(err, 0.99) > P99_F32:
            raise AssertionError(f"evaluate disagrees with the float64 plain version: {err.max()}")
        ph.info.update(launches=counts, route=res["route"], shape=list(vals.shape),
                       evaluate_wall_s=res["wall_s"], grid_p99_lane_err_vs_plain_f64=float(np.quantile(err, 0.99)),
                       nll_min=float(vals.min()), nll_max=float(vals.max()),
                       output=str(out_path.relative_to(ROOT)))
    eval_launches = counts["nll_fwd"]

    opt_path = OUT / "lv2_optimize.npz"
    for stale in OUT.glob("lv2_optimize.npz*"):
        stale.unlink()
    with Phase("optimize") as ph:
        opt_cfg = lv2_config(obs_path, opt_path)
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        res = optimize(opt_cfg)
        wall = time.perf_counter() - t0
        opt_counts = dict(nll_kernel.launches)
        final = np.asarray(res["nll_optims"][:, -1], np.float64)
        restarts, stages = res["nll_optims"].shape
        if (restarts, stages) != (100, 4) or res["params_optims"].shape != (100, 4, 2):
            raise AssertionError(f"optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if min(opt_counts.values()) <= 0 or res["route"] != "nll_fwd + nll_bwd kernels":
            raise AssertionError(f"optimize did not run both kernels: {opt_counts}, {res['route']}")
        finite = np.isfinite(final)
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of {restarts} restarts end finite")
        best = int(np.argmin(np.where(finite, final, np.inf)))
        # the NLL at the generating parameters, gamma = 0, by the same kernel
        kern = lv2_kernel(opt_cfg, torch.float32)
        truth = float(kern.launch(kern.physical(kern.spec.defaults_norm_opt()[None]), 0.0)[0])
        if not final[best] <= truth + 1e-3 * abs(truth):
            raise AssertionError(f"best final NLL {final[best]} above the generating parameters' {truth}")
        generating = kern.spec.defaults_flat[kern.spec.opt_indices].cpu().numpy()
        optimum = res["params_optims"][best, -1]
        rel = np.abs(optimum - generating) / generating
        if rel.max() > 0.10:
            raise AssertionError(f"best optimum {optimum} not within 10% of {generating}")
        ph.info.update(launches=opt_counts, route=res["route"], optimize_wall_s=wall,
                       restarts=restarts, stages=stages, finite_final=int(finite.sum()),
                       best_final_nll=float(final[best]), nll_at_generating_params=truth,
                       best_optimum=optimum.tolist(), generating=generating.tolist(),
                       optimum_rel_err=rel.tolist(), units=res["units"],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       output=str(opt_path.relative_to(ROOT)))
    widest = max(u["widest"] for u in res["units"])
    opt_gamma_sqrt = float(np.sqrt(res["gammas"][0]))

    with Phase("kernel_timing") as ph:
        # one launch of the main path: the first grid batch (256 lanes) at stage 0
        kern = lv2_kernel(cfg, torch.float32)
        p = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)[:256],
                            dtype=torch.float32, device=DEVICE)
        phys = kern.physical(p)
        g = grid_gammas[0]
        kern.launch(phys, g)
        torch.cuda.synchronize()
        ms = event_times(lambda: kern.launch(phys, g), 7)
        _, plain_ms = sync_time(lambda: nll_kernel.nll_plain(kern.cm, phys, kern.ys, g))
        b_ms, b_by, ops = bound_ms(kern.cm, 256)
        fwd_line = {"name": "nll_fwd", "route": "cuda",
                    "source": "ode_uncertainty_tpu_torch/csrc/nll_fwd.cu",
                    "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:722",
                    "launches": eval_launches + opt_counts["nll_fwd"],
                    "max_abs_err": lv2["kernel_f32_vs_plain_f64"]["max_abs_err"],
                    "ms": float(np.median(ms)), "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None}
        ph.info.update(shape=f"B=256, L={kern.cm.L}, d={kern.cm.d}, n_obs={kern.cm.n_obs}, float32",
                       event_ms=ms, ops=ops, launches_evaluate=eval_launches,
                       launches_optimize=opt_counts["nll_fwd"])

    with Phase("grad_timing") as ph:
        # one nll_bwd launch as optimize makes it: its widest dispatch, the
        # first stage's gamma, the parameter rows only (no d/d gamma)
        kern = lv2_kernel(cfg, torch.float32)
        p = torch.rand((widest, 2), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                       dtype=torch.float32, device=DEVICE)
        phys = kern.physical(p)
        g = torch.ones(widest, dtype=torch.float32, device=DEVICE)
        kern.grad.launch(phys, opt_gamma_sqrt, g, False)
        torch.cuda.synchronize()
        ms = event_times(lambda: kern.grad.launch(phys, opt_gamma_sqrt, g, False), 7)
        _, plain_ms = sync_time(lambda: nll_kernel.nll_grad_plain(kern.cm, phys, kern.ys, opt_gamma_sqrt, g))
        b_ms, b_by, ops = bound_ms(kern.cm, widest, grad=True)
        bwd_line = {"name": "nll_bwd", "route": "cuda",
                    "source": "ode_uncertainty_tpu_torch/csrc/nll_bwd.cu",
                    "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:851",
                    "launches": opt_counts["nll_bwd"],
                    "max_abs_err": lv2_grad["kernel_f32_vs_plain_f64"]["max_abs_err"],
                    "ms": float(np.median(ms)), "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None}
        # beside it: the same launch with d/d gamma^1/2 (one direction more),
        # and in float64
        ms_dgamma = event_times(lambda: kern.grad.launch(phys, opt_gamma_sqrt, g, True), 7)
        k64 = lv2_kernel(cfg, torch.float64)
        phys64, g64 = k64.physical(p.double()), g.double()
        k64.grad.launch(phys64, opt_gamma_sqrt, g64, False)
        ms64 = event_times(lambda: k64.grad.launch(phys64, opt_gamma_sqrt, g64, False), 7)
        ms64_fwd = event_times(lambda: k64.launch(phys64, opt_gamma_sqrt), 7)
        ph.info.update(shape=f"B={widest}, K={kern.cm.k_params} directions, L={kern.cm.L}, d={kern.cm.d}, "
                             f"n_obs={kern.cm.n_obs}, float32, gamma^1/2={opt_gamma_sqrt:.6g}",
                       event_ms=ms, ops=ops, library_call="none",
                       event_ms_with_dgamma=ms_dgamma, event_ms_float64=ms64, nll_fwd_event_ms_float64=ms64_fwd)

    with Phase("throughput") as ph:
        kern = bench_lv_kernel(torch.float32)
        p = torch.rand((8192, 2), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                       dtype=torch.float32, device=DEVICE)
        phys = kern.physical(p)
        g = float(np.sqrt(0.01))
        kern.launch(phys, g)
        torch.cuda.synchronize()
        ms = event_times(lambda: kern.launch(phys, g), 7)
        med = float(np.median(ms))
        _, plain_ms = sync_time(lambda: nll_kernel.nll_plain(kern.cm, phys[:, :1024].contiguous(), kern.ys, g))
        b_ms, b_by, ops = bound_ms(kern.cm, 8192)
        ph.info.update(workload="bench.py lv", batch=8192, steps=2000, obs_every=10, dtype="float32",
                       gamma=0.01, event_ms=ms, ms_per_launch=med,
                       filter_steps_per_s=8192 * 2000 / (med / 1e3),
                       plain_ms_b1024=plain_ms, bound_ms=b_ms, bound_by=b_by, ops=ops)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": [fwd_line, bwd_line]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
