"""The PyTorch port's ``evaluate`` entry point against the JAX CLI, its config
resolution, and its import hygiene.

``evaluate`` on params/lotkavolterra2 reads the real observation file at a
cut horizon (``tN=2``) and writes to a temporary H5 file; the NLL landscape
is compared with the JAX CLI's at float32 rtol 2e-4 / atol 1e-4 (the
tolerance of tests/test_pallas_ekf.py), the other keys exactly.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd, home, timeout=300):
    env = {
        "PYTHONPATH": str(REPO),
        "JAX_PLATFORMS": "cpu",
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": str(home),
    }
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                         cwd=cwd, timeout=timeout)
    assert out.returncode == 0, f"{args} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_evaluate_cli_matches_jax_cli(tmp_path):
    port_out, jax_out = tmp_path / "port.h5", tmp_path / "jax.h5"
    common = ["evaluate", "--experiment", "params/lotkavolterra2", "--set", "tN=2"]
    stdout = _run(["-m", "ode_uncertainty_tpu_torch.run_parameter_estimation", *common,
                   "--set", "device=cpu", "--set", f"output={port_out}"], cwd=tmp_path, home=tmp_path)
    assert "nll_fwd kernel" in stdout  # the kernel's route (its plain version on the CPU)
    _run(["run_parameter_estimation.py", *common, "--set", "platform=cpu",
          "--set", f"output={jax_out}"], cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(port_out, "r") as got, h5py.File(jax_out, "r") as ref:
        assert sorted(got) == sorted(ref) == ["gammas", "nll_evals", "param_evals", "timings"]
        for key in ("param_evals", "gammas"):
            np.testing.assert_array_equal(got[key][()], ref[key][()])
        assert got["timings"].shape == ref["timings"].shape
        assert got["nll_evals"].shape == (4, 400)
        np.testing.assert_allclose(got["nll_evals"][()], ref["nll_evals"][()], rtol=2e-4, atol=1e-4)


def test_registry_resolves_to_the_port():
    from ode_uncertainty_tpu_torch.filters import SqrtEKF
    from ode_uncertainty_tpu_torch.inference import LinearDecaySchedule
    from ode_uncertainty_tpu_torch.solvers import ERK
    from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment, parse_set_value

    raw = load_experiment("params/lotkavolterra2")
    assert Path(raw["y_path"]) == REPO / "results" / "noise_gt" / "lotkavolterra.h5"
    cfg = build_config(raw, {"tN": 2})
    assert cfg["ode_builder"].name == "lotka_volterra" and cfg["tN"] == 2
    assert isinstance(cfg["solver_builder"], ERK) and cfg["solver_builder"].tableau.name == "rkf45"
    assert type(cfg["filter_builder"]) is SqrtEKF and cfg["filter_builder"].disable_cov_update
    assert cfg["gamma_noise_schedule"] == LinearDecaySchedule(init_noise_log=-2.0, decay_rate=3.0)
    assert parse_set_value("2") == 2 and parse_set_value("cpu") == "cpu"


def test_evaluate_defaults_to_the_card(tmp_path):
    from ode_uncertainty_tpu_torch.run_parameter_estimation import main

    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks that no CPU fallback hides its absence")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["evaluate", "--experiment", "params/lotkavolterra2", "--set", "tN=0.1",
              "--set", f"output={tmp_path / 'x.h5'}"])


_HYGIENE = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    import numpy as np

    BLOCKED = ("jax", "jaxlib", "h5py", "yaml", "triton", "ode_uncertainty_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import ode_uncertainty_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401

    from ode_uncertainty_tpu_torch import models, solvers
    from ode_uncertainty_tpu_torch.run_parameter_estimation import main
    import torch
    sol = solvers.solve(solvers.rkf45(0.01), models.lotka_volterra(), 0.0,
                        torch.tensor([[1.0, 1.0]], dtype=torch.float64), 50)
    np.savez(sys.argv[1] + "/obs.npz", t=sol["t"].numpy(), x=sol["x"].numpy())
    main(["evaluate", "--experiment", "params/lotkavolterra2", "--set", "device=cpu",
          "--set", "tN=0.5", "--set", f"y_path={sys.argv[1]}/obs.npz",
          "--set", f"output={sys.argv[1]}/out.npz"])
    out = np.load(sys.argv[1] + "/out.npz")
    assert out["nll_evals"].shape == (4, 400) and np.isfinite(out["nll_evals"]).all()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("imported", len(names), "modules")
    """
)


def test_port_imports_no_jax_h5py_yaml_triton_or_the_jax_package(tmp_path):
    stdout = _run(["-c", _HYGIENE, str(tmp_path)], cwd=REPO, home=tmp_path)
    assert "imported" in stdout
    assert (tmp_path / "out.npz").exists()
