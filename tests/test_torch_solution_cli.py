"""The port's probabilistic-solution entry points (``run_ode_solver``,
``run_filter``, ``run_calibration``) against the JAX scripts
(``scripts/run_ode_solver.py``, ``run_filter.py``, ``run_calibration.py``),
on every configuration of the gt/*, noise_gt/*, ekf_trajectory/*,
pf_trajectory/* and calibration/* families that ``configs/experiments.py``
builds, plus run_filter's other branches (the four extension filters and
``use_static_cov_fn``), at float64 on the CPU with a cut horizon: the JAX
scripts run once, in one background subprocess, over all of them; the port
runs each in this process. The calibration/* configurations run the same
check from tests/test_torch_calibrate.py.

Horizons: gt/* one saved chunk (10 or 100 steps of h = 1e-4); noise_gt/*
one saved chunk (100 steps); ekf_trajectory/*, pf_trajectory/* and the
branches 5 steps of h = 0.01; calibration/* 5 steps, all 500 levels.

Tolerances: the output keys equal the JAX script's; t, x (and particle 0
of a particle run), y_hat, S_sqrt, R_sqrt, Q_sqrt, gamma_sqrt, the GMM
weights, activity and means, and the noise levels at rtol 1e-9 (atol
1e-12); eps and the covariance factors at rtol 1e-9 with atol 1e-15 times
the state's largest magnitude (the local-error estimate is a difference of
O(1) stage sums, whose rounding XLA and PyTorch take differently; the
square-root UKF's factor, through its center weight of about -129, at 1e-13
times it). The particles past 0 and the noise of noise_gt/* come from
another generator than the JAX script's: the difference of the two runs is
noise of variance 2 * noise_var (and a particle's perturbation of the step's
local-error scale), held within 6 standard deviations; their statistics are
held in tests/test_torch_particle.py and below over a longer horizon.
The calibration NLLs: within 10 times the change that moving each
observation by one ulp (up or down, signs from numpy seed 0) makes to the
port's own NLL (its largest within 5 levels either side), plus rtol 1e-9,
and the argmin level equal (see tests/test_torch_calibrate.py).
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu_torch import run_calibration, run_filter, run_ode_solver
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment
from ode_uncertainty_tpu_torch.utils.io import load_data

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "configs"))
import experiments  # noqa: E402

# calibration/* runs in tests/test_torch_calibrate.py (its own JAX subprocess)
FAMILIES = ("gt", "noise_gt", "ekf_trajectory", "pf_trajectory")
CONFIGS = [e for e in experiments.all_experiments() if e.split("/")[0] in FAMILIES]
LV = "ekf_trajectory/rkf45/lotkavolterra"
BRANCHES = {
    "EKF": {"filter_builder": {"class_path": "EKF"}},
    "UKF": {"filter_builder": {"class_path": "UKF"}},
    "UKF_SQRT": {"filter_builder": {"class_path": "UKF_SQRT"}},
    "GMM_EKF": {"filter_builder": {"class_path": "GMM_EKF"}},
    "static": {"use_static_cov_fn": True, "filter_builder": {
        "class_path": "SQRT_EKF", "init_args": {
            "static_cov_update_fn_builder": {"class_path": "StaticDiagonalCovarianceUpdate",
                                             "init_args": {"scale": 0.01}}}}},
}
CASES = [(name, name, {}) for name in CONFIGS] + [(f"{LV}+{b}", LV, o) for b, o in BRANCHES.items()]


def _overrides(name: str, extra: dict, out: Path) -> dict:
    raw = experiments.build(name)
    family = name.split("/")[0]
    h = raw["solver_builder"]["init_args"]["step_size"]
    steps = raw["save_interval"] if family in ("gt", "noise_gt") else 5
    over = {"tN": raw["t0"] + steps * h, "float64": True, "output": str(out)}
    if raw.get("y_path"):
        over["y_path"] = str((REPO / "configs" / raw["y_path"]).resolve())
    return {**over, **extra}


_JAX_DRIVER = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, "scripts"); sys.path.insert(0, "configs")
    import experiments, run_calibration, run_filter, run_ode_solver
    from ode_uncertainty_tpu.utils.config import apply_runtime_config, instantiate

    SCRIPT = {"gt": run_ode_solver, "noise_gt": run_ode_solver, "ekf_trajectory": run_filter,
              "pf_trajectory": run_filter, "calibration": run_calibration}
    for name, over in json.load(open(sys.argv[1])):
        raw = experiments.build(name)
        raw.update(over, platform="cpu")
        apply_runtime_config(raw)
        SCRIPT[name.split("/")[0]].main({k: instantiate(v) for k, v in raw.items()})
        open(over["output"][:-3] + ".done", "w").close()
    """
)


class JaxScripts:
    """The JAX scripts over ``cases`` in one background subprocess, started at
    once so that it runs beside the port's runs; ``output(i)`` waits for
    case i's file."""

    def __init__(self, cases, tmp: Path):
        self.tmp = tmp
        jobs = [(base, _overrides(base, extra, tmp / f"{i}.h5")) for i, (_, base, extra) in enumerate(cases)]
        (tmp / "jobs.json").write_text(json.dumps(jobs))
        env = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "HOME": str(tmp), "ODEUQ_JAX_CACHE": str(tmp / "cache")}
        self.log = open(tmp / "log.txt", "w")
        self.proc = subprocess.Popen([sys.executable, "-c", _JAX_DRIVER, str(tmp / "jobs.json")], env=env,
                                     cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT)

    def output(self, i: int) -> dict:
        done = self.tmp / f"{i}.done"
        deadline = time.monotonic() + 600
        while not done.exists():
            if self.proc.poll() not in (None, 0) or time.monotonic() > deadline:
                self.close()
                raise AssertionError((self.tmp / "log.txt").read_text()[-4000:])
            time.sleep(0.05)
        with h5py.File(self.tmp / f"{i}.h5", "r") as f:
            return {k: f[k][()] for k in f}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    scripts = JaxScripts(CASES, tmp_path_factory.mktemp("jax"))
    yield scripts
    scripts.close()


TIGHT = {"t", "x", "y_hat", "S_sqrt", "R_sqrt", "Q_sqrt", "gamma_sqrt", "weights", "active", "means",
         "noise_levels"}


def _port(base, extra, out):
    fam = base.split("/")[0]
    cfg = build_config(load_experiment(base), {**_overrides(base, extra, out), "device": "cpu"})
    entry = {"gt": run_ode_solver, "noise_gt": run_ode_solver, "calibration": run_calibration}.get(fam, run_filter)
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in entry.run(cfg).items()}, cfg


def _envelope(change: np.ndarray, reach: int = 5) -> np.ndarray:
    """Largest change within ``reach`` noise levels either side: one draw of
    ulp moves can leave a single level nearly unmoved by chance."""
    change = np.atleast_1d(change)
    return np.array([change[max(0, i - reach):i + reach + 1].max() for i in range(change.size)])


def _ulp_moved(x: np.ndarray) -> np.ndarray:
    """Each element moved by one ulp up or down (signs from numpy seed 0)."""
    return np.nextafter(x, np.random.default_rng(0).choice([-np.inf, np.inf], x.shape))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_entry_point_matches_the_jax_script(case, jax_outputs, tmp_path):
    check_case(case, lambda: jax_outputs.output(CASES.index(case)), tmp_path)


def check_case(case, jax_output, tmp_path: Path):
    """The port's run of ``case`` against the JAX script's output (from
    ``jax_output()``, called after the port's run)."""
    label, base, extra = case
    got, cfg = _port(base, extra, tmp_path / "port.npz")
    ref = jax_output()
    assert sorted(got) == sorted(ref), (sorted(got), sorted(ref))
    fam = base.split("/")[0]
    state = got.get("x", got.get("means"))
    scale = float(np.abs(state).max()) if state is not None else 1.0
    cov_atol = (1e-13 if "UKF_SQRT" in label else 1e-15) * scale
    noise_var = cfg.get("noise_var", 0.0)
    for key in sorted(got):
        g, r = got[key], ref[key]
        assert g.shape == r.shape, key
        if fam == "calibration" and key != "noise_levels":
            continue
        if fam == "pf_trajectory" and key == "eps":
            g, r = g[:, 0], r[:, 0]  # the others follow their particles' noise
        if (fam == "pf_trajectory" or (fam == "noise_gt" and noise_var > 0)) and key == "x":
            if fam == "pf_trajectory":
                np.testing.assert_allclose(g[:, 0], r[:, 0], rtol=1e-9, atol=1e-12)
                g, r = g[:, 1:], r[:, 1:]
                sd = np.sqrt(2.0) * max(float(np.abs(got["eps"]).max()), 1e-300)
            else:
                sd = np.sqrt(2.0 * noise_var)
            assert np.all(np.abs(g - r) <= 6.0 * sd), key
            continue
        if key in TIGHT:
            np.testing.assert_allclose(g.astype(float), r.astype(float), rtol=1e-9, atol=1e-12, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-9, atol=cov_atol, err_msg=key)
    if fam == "calibration":
        # the NLLs, within their conditioning (one ulp on each observation)
        data = load_data(cfg["y_path"])
        np.savez(tmp_path / "ulp.npz", t=data["t"], x=_ulp_moved(data["x"]))
        ulp, _ = _port(base, {**extra, "y_path": str(tmp_path / "ulp.npz")}, tmp_path / "ulp_out.npz")
        for key in ("nll_conrad", "nll_ours"):
            gap, cond = np.abs(got[key] - ref[key]), _envelope(np.abs(ulp[key] - got[key]))
            assert np.all(gap <= 10.0 * cond + 1e-9 * np.abs(ref[key])), (key, (gap / np.abs(ref[key])).max())
        assert int(np.argmin(got["nll_conrad"])) == int(np.argmin(ref["nll_conrad"]))


# float32: the shipped trajectory and calibration configs run in float32 by
# default, where LV's covariance and the calibration NLLs lie orders of
# magnitude off float64 (the local-error estimate is rounding noise there).
# The JAX scripts' own float32-vs-float64 gap is the witness: the port's
# float32 run lies within 10 times it of the JAX float64 run, key by key
# (trajectories relative to each saved step's largest element of the float64
# run, NLLs and levels elementwise relative).
F32_STEPS = {LV: 500, "calibration/rkf45/lotkavolterra": 200}
F32_CASES = [(f"{name}+f{bits}", name, {"float64": bits == 64}) for name in F32_STEPS for bits in (64, 32)]
F32_GAP_FACTOR = 10.0


def _f32_extra(name: str, extra: dict) -> dict:
    raw = experiments.build(name)
    return {**extra, "tN": raw["t0"] + F32_STEPS[name] * raw["solver_builder"]["init_args"]["step_size"]}


@pytest.fixture(scope="module")
def jax_f32_outputs(tmp_path_factory):
    scripts = JaxScripts([(label, name, _f32_extra(name, extra)) for label, name, extra in F32_CASES],
                         tmp_path_factory.mktemp("jax_f32"))
    yield scripts
    scripts.close()


def _gap_to(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest |got - ref|: relative to each saved step's largest |ref| for a
    trajectory, elementwise relative for a vector (0 where both are 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    if ref.ndim > 1:
        scale = np.abs(ref).max(axis=tuple(range(1, ref.ndim)), keepdims=True)
    else:
        scale = np.abs(ref)
    return float(np.where(diff == 0, 0.0, diff / np.where(scale > 0, scale, np.inf)).max())


@pytest.mark.parametrize("name", list(F32_STEPS))
def test_float32_run_stays_within_the_jax_scripts_float32_gap(name, jax_f32_outputs, tmp_path):
    i = [c[1] for c in F32_CASES].index(name)
    got, _ = _port(name, _f32_extra(name, F32_CASES[i + 1][2]), tmp_path / "port.npz")
    ref64, ref32 = jax_f32_outputs.output(i), jax_f32_outputs.output(i + 1)
    assert sorted(got) == sorted(ref32)
    for key in sorted(got):
        assert got[key].dtype == np.float32 or key == "active", key
        port_gap, jax_gap = _gap_to(got[key], ref64[key]), _gap_to(ref32[key], ref64[key])
        assert port_gap <= F32_GAP_FACTOR * jax_gap, (key, port_gap, jax_gap)


@pytest.mark.parametrize("experiment", ["noise_gt/lorenz", "noise_gt/lcao"])
def test_noise_gt_noise_statistics(experiment, tmp_path):
    """noise_gt's observation noise: the port's output minus its noise-free
    solve, over 1,000 saved states, has a sample mean within 5 standard
    errors of 0 and a sample variance within 5 standard errors of
    noise_var (the standard error of a variance is noise_var * sqrt(2 / (N -
    1)))."""
    raw = load_experiment(experiment)
    h = raw["solver_builder"]["init_args"]["step_size"]
    over = {"device": "cpu", "float64": True, "save_interval": 1, "tN": raw["t0"] + 1000 * h}
    noisy = run_ode_solver.run(build_config(raw, {**over, "output": str(tmp_path / "a.npz")}))
    clean = run_ode_solver.run(build_config(raw, {**over, "noise_var": 0.0, "output": str(tmp_path / "b.npz")}))
    noise = (noisy["x"] - clean["x"]).numpy().ravel()
    nv = raw["noise_var"]
    assert abs(noise.mean()) <= 5.0 * np.sqrt(nv / noise.size)
    assert abs(noise.var(ddof=1) - nv) <= 5.0 * nv * np.sqrt(2.0 / (noise.size - 1))
    again = run_ode_solver.run(build_config(raw, {**over, "output": str(tmp_path / "c.npz")}))
    torch.testing.assert_close(again["x"], noisy["x"], rtol=0, atol=0)  # the seed fixes the draws


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks that no CPU fallback hides its absence")
    for main, name in ((run_filter.main, LV), (run_ode_solver.main, "gt/lotkavolterra"),
                       (run_calibration.main, "calibration/rkf45/lotkavolterra")):
        with pytest.raises((RuntimeError, AssertionError)):
            main(["--experiment", name, "--set", "tN=0.02", "--set", f"output={tmp_path / 'x.npz'}"])
