"""The port's ``optimize`` CLI on params/hodgkinhuxley1_r4 (Kvaerno3, the
kernels' route: nll_fwd and the Kvaerno3 nll_bwd, their plain versions on
the CPU) against the JAX CLI.

Both CLIs run float64 at a cut horizon (``tN=0.3``, 30 steps, before the
stimulus starts at t = 10, so the two routes' time rules agree) on the
shipped H5 observations, 2 tempering stages, 2 L-BFGS iterations, from the
default point (``num_random_runs=0``: the two frameworks draw different
random restarts). ``lbfgs_tol=0.0`` makes both run their iterations: before
the onset the NLL is nearly flat in g_Na, and the default tolerance stops
both at the first point, where no gradient would steer a step. Tolerances,
as tests/test_torch_optimize.py holds Lotka-Volterra: ``params_optims`` atol
1e-6, ``nll_optims`` rtol 1e-8, the iteration and evaluation counters
identical.
"""

import h5py
import numpy as np

from test_torch_hh_cli import REPO, _run


def test_hh_optimize_cli_matches_jax_cli(tmp_path):
    port_out, jax_out = tmp_path / "port.h5", tmp_path / "jax.h5"
    common = ["optimize", "--experiment", "params/hodgkinhuxley1_r4", "--set", "tN=0.3",
              "--set", "num_random_runs=0", "--set", "num_tempering_stages=2",
              "--set", "lbfgs_maxiter=2", "--set", "lbfgs_tol=0.0", "--set", "float64=true"]
    stdout = _run(["-m", "ode_uncertainty_tpu_torch.run_parameter_estimation", *common,
                   "--set", "device=cpu", "--set", f"output={port_out}"], cwd=tmp_path, home=tmp_path)
    assert "nll_fwd + nll_bwd kernels" in stdout  # the kernels' route (plain versions on the CPU)
    _run(["run_parameter_estimation.py", *common, "--set", "platform=cpu",
          "--set", f"output={jax_out}"], cwd=REPO / "scripts", home=tmp_path)
    with h5py.File(port_out, "r") as got, h5py.File(jax_out, "r") as ref:
        assert sorted(got) == sorted(ref)
        for key in ("params_inits", "params_default", "params_name", "gammas",
                    "num_lbfgs_iters", "num_nll_evals", "num_nll_jac_evals"):
            np.testing.assert_array_equal(got[key][()], ref[key][()], err_msg=key)
        assert got["params_optims"].shape == (1, 2, 1)
        assert (got["num_lbfgs_iters"][()] == 2).all()
        np.testing.assert_allclose(got["params_optims"][()], ref["params_optims"][()], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["nll_optims"][()], ref["nll_optims"][()], rtol=1e-8)
