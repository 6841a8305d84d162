"""ode-uncertainty in PyTorch and CUDA: the port of ``ode_uncertainty_tpu``.

The JAX package stays the reference; this package mirrors its subpackage
layout file by file, so every module here sits beside the module it is held
against in ``tests/test_torch_*.py``:

  * ``models``    — ODE right-hand sides and their default parameters.
  * ``solvers``   — embedded explicit Runge-Kutta steppers and the unroll.
  * ``ops``       — square-root linear algebra, the rank-1 Cholesky update,
                    linearization, alignment and the hand-written CUDA NLL
                    kernel (``ops/nll_kernel.py``, source in ``csrc/``).
  * ``filters``   — the square-root EKF, the particle filter and the
                    extension filters (dense EKF, UKF, square-root UKF,
                    Gaussian-mixture sqrt-EKF).
  * ``inference`` — parameter box, observations, the tempered NLL, the NLL
                    landscape, the host L-BFGS, the trajectory drivers and
                    the calibration sweep.
  * ``parallel``  — restart sharding over several devices: the mesh, the
                    sharded tempered estimator and NLL landscape, and the
                    sharded dispatch of the host L-BFGS (``mesh=``).
  * ``utils``     — H5 IO, config instantiation, the loop (with CUDA graphs
                    on the card), the kernel build.

Entry points: ``run_parameter_estimation`` (optimize, evaluate),
``run_parameter_estimation_baseline``, ``compute_trmse``,
``run_ode_solver``, ``run_filter`` and ``run_calibration``; the tools
``measure_scaling`` (weak scaling of the mesh), ``compare_optimizer``
(the L-BFGS optimizers against scipy's L-BFGS-B), ``diag_nan_lanes``
(classifies diverged restarts), ``report_estimation`` and
``results_inventory`` (host-only reports of results).

Tensors carry an explicit leading batch dimension where the JAX package used
``vmap``. Entry points run on ``device="cuda"`` unless the caller passes
another device; nothing falls back to the CPU on its own.
"""

__version__ = "0.1.0"
