"""The port's ``diag_nan_lanes`` against ``scripts/diag_nan_lanes.py`` on the
committed result ``results/params/hodgkinhuxley11_full.h5`` (HH full, n = 8,
Kvaerno3, 11 optimized parameters).

* The lanes and stages it re-evaluates: every lane whose final NLL is not
  finite, at the start of its first non-finite stage (the JAX script's rule).
* The evaluator (the entry points' NLL, the kernels' plain version on the
  CPU) against the JAX script's ``build_nll`` on those points, float64 and
  float32, with both experiments cut from 10^4 steps to 20 (the JAX script
  compiles its objective on every call, ~15 s at n = 8): float64 at rtol
  1e-9, float32 at the implicit step's limit (p99 of |port - JAX| / (|JAX| +
  1) <= 5e-4). The JAX script hands its objective ``gamma`` where it takes
  ``gamma^1/2`` (q_sqrt is I for this experiment on both sides); the port
  evaluates at ``gamma^1/2``, so JAX is called here with ``gamma^1/2``.
* The port's table on the CPU at 5 steps: one row per lane, the
  classification rule of the JAX script.
"""

import importlib.util
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from ode_uncertainty_tpu_torch import diag_nan_lanes
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

REPO = Path(__file__).resolve().parent.parent
H5 = REPO / "results" / "params" / "hodgkinhuxley11_full.h5"
TN = 0.2  # 20 Kvaerno3 steps of 0.01
P99_F32 = 5e-4


@pytest.fixture(scope="module")
def cases():
    with h5py.File(H5, "r") as f:
        return diag_nan_lanes.nan_cases({k: f[k][()] for k in f})


def port_config():
    return build_config(load_experiment(diag_nan_lanes.EXPERIMENT), {"device": "cpu", "tN": TN})


def test_cases_are_the_jax_scripts(cases):
    with h5py.File(H5, "r") as f:
        nll, gammas = f["nll_optims"][()], f["gammas"][()]
    bad = np.nonzero(~np.isfinite(nll[:, -1]))[0]
    assert [c[0] for c in cases] == bad.tolist() and len(cases) == 7
    for lane, stage, entry, gamma in cases:
        assert np.isfinite(nll[lane, :stage]).all() and not np.isfinite(nll[lane, stage])
        assert gamma == float(gammas[stage]) and entry.shape == (11,)


@pytest.mark.parametrize("tag", ["f64", "f32"])
def test_evaluator_matches_the_jax_script(cases, tag, monkeypatch):
    import torch

    monkeypatch.chdir(REPO / "scripts")  # the JAX configs' paths are relative to scripts/
    spec = importlib.util.spec_from_file_location("jax_diag_nan_lanes", REPO / "scripts" / "diag_nan_lanes.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.syspath_prepend(str(REPO / "configs"))
    import experiments

    monkeypatch.setattr(experiments, "build", lambda name, build=experiments.build: {**build(name), "tN": TN})
    points = np.stack([c[2] for c in cases])
    gamma = cases[0][3]
    ref = np.asarray(script.build_nll(tag)(points, np.sqrt(gamma)), np.float64)
    dtype = torch.float64 if tag == "f64" else torch.float32
    got = diag_nan_lanes.build_nll(port_config(), dtype)(points, gamma)
    assert got.shape == ref.shape == (7,) and np.isfinite(ref).all()
    if tag == "f64":
        np.testing.assert_allclose(got, ref, rtol=1e-9)
    else:
        assert np.quantile(np.abs(got - ref) / (np.abs(ref) + 1.0), 0.99) <= P99_F32


def test_table_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["diag_nan_lanes"])
    rows = diag_nan_lanes.main(["--set", "device=cpu", "--set", "tN=0.05", "--set", f"parameter_estimates_input={H5}"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["lane", "stage", "gamma", "nll_f32", "nll_f64", "classification"]
    assert [r["lane"] for r in rows] == [1, 8, 9, 10, 22, 70, 89] and len(out) == 8
    for r in rows:
        assert r["classification"] == diag_nan_lanes.classify(r["nll_f32"], r["nll_f64"])
    assert diag_nan_lanes.classify(np.nan, 1.0) == "f32-numerics"
    assert diag_nan_lanes.classify(np.nan, np.nan) == "divergent-filter (param point)"
    assert diag_nan_lanes.classify(1.0, 2.0) == "finite-on-reeval (runtime/optimizer state)"
