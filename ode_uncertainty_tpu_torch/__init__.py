"""ode-uncertainty in PyTorch and CUDA: the port of ``ode_uncertainty_tpu``.

The JAX package stays the reference; this package mirrors its subpackage
layout file by file, so every module here sits beside the module it is held
against in ``tests/test_torch_*.py``:

  * ``models``    — ODE right-hand sides and their default parameters.
  * ``solvers``   — embedded explicit Runge-Kutta steppers and the unroll.
  * ``ops``       — square-root linear algebra, linearization, alignment and
                    the hand-written CUDA NLL kernel (``ops/nll_kernel.py``,
                    source in ``csrc/``).
  * ``filters``   — the square-root EKF.
  * ``inference`` — parameter box, observations, the tempered NLL and the
                    NLL landscape.
  * ``utils``     — H5 IO, config instantiation, the kernel build.

Tensors carry an explicit leading batch dimension where the JAX package used
``vmap``. Entry points run on ``device="cuda"`` unless the caller passes
another device; nothing falls back to the CPU on its own.
"""

__version__ = "0.1.0"
