"""The port's small utilities against the JAX package's: ``utils/debug.py``
(non-finite counts over nested containers), ``utils/profiling.py`` (phase
timer, benchmark helper, ``torch.profiler`` trace), ``utils/runlock.py``
(the bench lock and the client pid file, the same protocol) and the config
system's diffrax alias (``DiffraxSolverBuilder`` onto the port's solvers)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu.utils import debug as j_debug
from ode_uncertainty_tpu.utils import runlock as j_runlock
from ode_uncertainty_tpu.utils.config import resolve_class as j_resolve_class
from ode_uncertainty_tpu_torch.solvers import ERK, Kvaerno3
from ode_uncertainty_tpu_torch.utils import debug, profiling, runlock
from ode_uncertainty_tpu_torch.utils.config import build_config, resolve_class


def test_count_nonfinite_and_assert_finite_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((4, 3)), rng.standard_normal(5)
    a[1, 2], b[0], b[3] = np.nan, np.inf, -np.inf
    ints = np.arange(3)
    as_torch = {"a": torch.as_tensor(a), "rest": [torch.as_tensor(b), (torch.as_tensor(ints), torch.as_tensor(a[:1]))]}
    as_jax = {"a": jnp.asarray(a), "rest": [jnp.asarray(b), (jnp.asarray(ints), jnp.asarray(a[:1]))]}
    assert int(debug.count_nonfinite(as_torch)) == int(j_debug.count_nonfinite(as_jax)) == 3
    assert int(debug.count_nonfinite([torch.arange(3)])) == 0
    with pytest.raises(FloatingPointError, match="lanes: 3 non-finite values"):
        debug.assert_finite(as_torch, "lanes")
    debug.assert_finite({"ok": torch.ones(3)})


def test_phase_timer_benchmark_and_trace(tmp_path):
    timer = profiling.PhaseTimer()
    x = torch.ones(64, 64)
    for _ in range(3):
        with timer.phase("matmul", sync=x):
            x = x @ x / 64.0
    with timer.phase("idle"):
        pass
    assert timer.counts == {"matmul": 3, "idle": 1} and timer.totals["matmul"] > 0.0
    assert timer.report().splitlines()[0].startswith("matmul")
    first_s, per_call = profiling.benchmark(lambda y: y @ y, x, reps=3, warmup=2)
    assert first_s > 0.0 and per_call > 0.0
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert any("mm" in e.key for e in prof.key_averages())
    assert "traceEvents" in json.loads((tmp_path / "trace" / "trace.json").read_text())


@pytest.mark.parametrize("impl", [runlock, j_runlock], ids=["port", "jax"])
def test_runlock_protocol(tmp_path, monkeypatch, impl):
    # the same protocol on both sides: a live lock is active, a stale one is
    # removed, and a client yields with exit code 75 while the lock is held
    lock, pidfile = str(tmp_path / "bench.lock"), str(tmp_path / "client.pid")
    monkeypatch.setattr(impl, "BENCH_LOCK", lock)
    monkeypatch.setattr(impl, "CLIENT_PID_FILE", pidfile)
    assert not impl.bench_lock_active()
    impl.acquire_bench_lock()
    assert impl.bench_lock_active()
    with pytest.raises(impl.QuiesceRequested) as exc:
        impl.check_quiesce("test")
    assert exc.value.code == impl.QUIESCE_EXIT_CODE == 75
    impl.release_bench_lock()
    assert not os.path.exists(lock)
    with open(lock, "w") as f:
        f.write("999999999")
    assert not impl.bench_lock_active() and not os.path.exists(lock)
    impl.register_client()
    assert impl.active_client_pid() is None  # our own pid is not another client


def test_runlock_defaults_lie_in_the_temporary_directory():
    import tempfile

    if "ODEUQ_BENCH_LOCK" not in os.environ:
        assert os.path.dirname(runlock.BENCH_LOCK) == tempfile.gettempdir()
    if "ODEUQ_CLIENT_PID" not in os.environ:
        assert os.path.dirname(runlock.CLIENT_PID_FILE) == tempfile.gettempdir()


def test_diffrax_alias_maps_onto_the_ports_solvers():
    node = {"class_path": "src.solvers.DiffraxSolverBuilder", "init_args": {"name": "Kvaerno3", "step_size": 0.05}}
    solver = build_config({"solver_builder": node})["solver_builder"]
    ref = j_resolve_class(node["class_path"])(**node["init_args"])
    assert isinstance(solver, Kvaerno3) and solver.h == ref.h == 0.05
    rkf = resolve_class("DiffraxSolverBuilder")(name="RKF45", step_size=0.01)
    assert isinstance(rkf, ERK) and rkf.name == "rkf45" and rkf.h == 0.01
    with pytest.raises(ValueError, match="No native equivalent"):
        resolve_class("DiffraxSolverBuilder")(name="Tsit5")
