"""The port's ``compare_optimizer`` against ``scripts/compare_optimizer.py``
on the CPU in float64: params/lotkavolterra2 cut to tN = 0.5 (50 steps) and
one tempering stage (gamma = 0), 4 restarts, ``--maxiter 10``, the same
restarts (the JAX script's, from its CLI's ``_initial_restarts``) on both
sides.

The JAX script runs in this process with its experiment builder cut the
same way and its optimizers' results recorded as it calls them; its table
prints 3 decimals, the recorded arrays hold every digit. Per optimizer
(scipy L-BFGS-B, the host L-BFGS, the device L-BFGS): the best and median
final NLL at rtol 1e-9, every restart's evaluation count equal. On the CPU
a value-and-gradient call of the port's objective (the kernels' plain
versions) costs ~0.7 s at 50 steps: scipy's loop makes ~50 such calls
here, one restart at a time, hence the cut.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import ode_uncertainty_tpu.inference.estimate as j_estimate
import ode_uncertainty_tpu.inference.lbfgs_host as j_lbfgs_host
from ode_uncertainty_tpu_torch import compare_optimizer
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

REPO = Path(__file__).resolve().parent.parent
EXPERIMENT = "params/lotkavolterra2"
CUT = {"tN": 0.5, "num_tempering_stages": 1}
RESTARTS, MAXITER = 4, 10


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_compare_optimizer", REPO / "scripts" / "compare_optimizer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recording(make, runs: list):
    """``make`` whose stage functions append each stage's result to ``runs``."""

    def made(*args, **kwargs):
        stage = make(*args, **kwargs)

        def recorded(*a, **kw):
            res = stage(*a, **kw)
            runs.append(res)
            return res

        return recorded

    return made


def _summary(f, nfev) -> dict:
    f = np.asarray(f, np.float64)
    return {"best": float(np.min(f)), "median": float(np.median(f)), "nfev": np.asarray(nfev, np.int64)}


def test_compare_optimizer_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ODEUQ_PLATFORM", "cpu")
    monkeypatch.chdir(REPO / "scripts")  # the JAX configs' paths are relative to scripts/
    script = _jax_script()
    monkeypatch.setattr(script, "setup_precision", lambda cfg: jnp.float64)  # the tests run JAX in float64
    import configs.experiments as experiments
    import run_parameter_estimation as j_cli

    monkeypatch.setattr(experiments, "build", lambda name, build=experiments.build: {**build(name), **CUT})
    starts, host_runs, device_runs, scipy_runs = [], [], [], []

    def initial_restarts(*args, restarts=j_cli._initial_restarts):
        starts.append(np.asarray(restarts(*args), np.float64))
        return starts[-1]

    def run_scipy(*args, run=script.run_scipy):
        scipy_runs.append(run(*args))
        return scipy_runs[-1]

    monkeypatch.setattr(j_cli, "_initial_restarts", initial_restarts)
    monkeypatch.setattr(script, "run_scipy", run_scipy)
    monkeypatch.setattr(j_lbfgs_host, "make_stage_optimizer_host",
                        _recording(j_lbfgs_host.make_stage_optimizer_host, host_runs))
    monkeypatch.setattr(j_estimate, "make_stage_optimizer", _recording(j_estimate.make_stage_optimizer, device_runs))
    monkeypatch.setattr(sys, "argv", ["compare_optimizer.py", "--restarts", str(RESTARTS), "--maxiter", str(MAXITER)])
    script.main()
    table = capsys.readouterr().out
    assert len(starts) == 1 and len(host_runs) == len(device_runs) == 1 and len(scipy_runs) == 1
    ref = {
        "scipy L-BFGS-B": _summary(scipy_runs[0][1], scipy_runs[0][2]),
        "host L-BFGS (ours)": _summary(host_runs[0].f, host_runs[0].n_fev),
        "device L-BFGS (ours)": _summary(device_runs[0].f, device_runs[0].n_fev),
    }

    cfg = build_config(load_experiment(EXPERIMENT),
                       {"float64": True, "num_random_runs": RESTARTS, "device": "cpu", **CUT})
    out = compare_optimizer.compare(cfg, MAXITER, p0=starts[0])
    assert out["gammas"].tolist() == [0.0] and out["device"] == "cpu"
    assert [row[0] for row in out["rows"]] == list(ref)
    for name, (x, f, nfev, wall) in out["results"].items():
        got, want = _summary(f, nfev), ref[name]
        np.testing.assert_allclose([got["best"], got["median"]], [want["best"], want["median"]], rtol=1e-9,
                                   err_msg=name)
        np.testing.assert_array_equal(got["nfev"], want["nfev"], err_msg=name)
        assert name in table and x.shape == (RESTARTS, 2)
    # the hit rates, best parameter errors and mean counts of the rows follow
    # from these; the table prints them as the reference does
    row = out["rows"][0]
    assert 0.0 <= row[1] <= 1.0 and row[5] == float(np.mean(ref[row[0]]["nfev"]))


def test_compare_optimizer_runs_in_float64_only():
    cfg = build_config(load_experiment(EXPERIMENT), {"float64": False, "device": "cpu", **CUT})
    with pytest.raises(ValueError, match="float64"):
        compare_optimizer.compare(cfg, MAXITER)
