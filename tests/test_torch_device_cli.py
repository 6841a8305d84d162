"""``optimize --set optimizer_mode=device`` of the port's CLI against the JAX
CLI's (params/lotkavolterra2 at tN = 0.5, the defaults as the one restart,
2 tempering stages, ``lbfgs_maxiter=4``, float64): the same keys, the
counters, inits and names equal, optima to 1e-10 absolute and NLLs to
1e-10 relative (the port runs the kernels' plain versions, JAX its XLA
``make_nll``). And the import hygiene of this slice's entry points: the
device-mode ``optimize``, the baseline's ``optimize`` and ``evaluate`` and
``compute_trmse`` run without jax, h5py, yaml or the JAX package.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import h5py
import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd, home, timeout=300):
    env = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(home)}
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout)
    assert out.returncode == 0, f"{args} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_device_mode_cli_matches_jax_cli(tmp_path):
    port_out, jax_out = tmp_path / "port.h5", tmp_path / "jax.h5"
    common = ["optimize", "--experiment", "params/lotkavolterra2", "--set", "tN=0.5", "--set", "num_random_runs=0",
              "--set", "num_tempering_stages=2", "--set", "lbfgs_maxiter=4", "--set", "float64=true",
              "--set", "optimizer_mode=device"]
    stdout = _run(["-m", "ode_uncertainty_tpu_torch.run_parameter_estimation", *common, "--set", "device=cpu",
                   "--set", f"output={port_out}"], cwd=tmp_path, home=tmp_path)
    assert "nll_fwd + nll_bwd kernels, device L-BFGS" in stdout
    _run(["run_parameter_estimation.py", *common, "--set", "platform=cpu", "--set", f"output={jax_out}"],
         cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(port_out, "r") as got, h5py.File(jax_out, "r") as ref:
        assert sorted(got) == sorted(ref)
        for key in ("params_inits", "params_default", "params_name", "gammas",
                    "num_lbfgs_iters", "num_nll_evals", "num_nll_jac_evals"):
            np.testing.assert_array_equal(got[key][()], ref[key][()], err_msg=key)
        assert got["params_optims"].shape == (1, 2, 2) and (got["num_lbfgs_iters"][()] > 1).all()
        np.testing.assert_allclose(got["params_optims"][()], ref["params_optims"][()], rtol=0, atol=1e-10)
        np.testing.assert_allclose(got["nll_optims"][()], ref["nll_optims"][()], rtol=1e-10)


_HYGIENE = textwrap.dedent(
    """
    import sys
    import numpy as np

    BLOCKED = ("jax", "jaxlib", "h5py", "yaml", "triton", "ode_uncertainty_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    from ode_uncertainty_tpu_torch import compute_trmse, models, run_parameter_estimation_baseline, solvers
    from ode_uncertainty_tpu_torch.run_parameter_estimation import main
    from ode_uncertainty_tpu_torch.utils import debug, profiling, runlock
    d = sys.argv[1]
    sol = solvers.solve(solvers.rkf45(0.01), models.lotka_volterra(), 0.0,
                        torch.tensor([[1.0, 1.0]], dtype=torch.float64), 30)
    np.savez(d + "/obs.npz", t=sol["t"].numpy(), x=sol["x"].numpy())
    cut = ["--set", "device=cpu", "--set", "tN=0.3", "--set", f"y_path={d}/obs.npz"]
    main(["optimize", "--experiment", "params/lotkavolterra2", *cut, "--set", "num_random_runs=2",
          "--set", "num_tempering_stages=2", "--set", "lbfgs_maxiter=2", "--set", "optimizer_mode=device",
          "--set", f"output={d}/out.npz"])
    compute_trmse.main(["--experiment", "params/lotkavolterra2", *cut, "--set", f"parameter_estimates_input={d}/out.npz"])
    for command in ("optimize", "evaluate"):
        run_parameter_estimation_baseline.main([command, "--experiment", "params_baseline/lotkavolterra2", *cut,
                                                "--set", "num_random_runs=2", "--set", "lbfgs_maxiter=2",
                                                "--set", "num_param_evals={'alpha': 2, 'beta': 2}",
                                                "--set", f"output={d}/base.npz"])
    out, base = np.load(d + "/out.npz"), np.load(d + "/base.npz")
    assert out["params_optims"].shape == (2, 2, 2) and out["trmse_values"].shape == (2,)
    assert base["params_optims"].shape == (2, 2) and base["nll_evals"].shape == (1, 4)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ran without", ", ".join(BLOCKED))
    """
)


def test_slice_entry_points_import_no_jax_h5py_yaml_or_the_jax_package(tmp_path):
    stdout = _run(["-c", _HYGIENE, str(tmp_path)], cwd=REPO, home=tmp_path)
    assert "ran without" in stdout
