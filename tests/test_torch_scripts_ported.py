"""The port's counterparts of three JAX scripts held against the scripts
themselves on the same small input:

* ``measure_scaling`` against ``scripts/measure_scaling.py --path host
  --devices 1,2 --per-device 2``: the same keys on each line (the port adds
  the cards used), finite wall times, one line per device count. The port
  runs on meshes of ``cpu`` devices, its rig cut from 40 steps to 20 and
  from 25 iterations and 3 timed calls to 2 and 1 (each shard's value and
  gradient costs ~0.2 s on the CPU whatever its width); its ``--path
  device`` is the sharded estimator, held in tests/test_torch_mesh.py;
* ``report_estimation`` on ``results/params/lotkavolterra2.h5``: the same
  printed report but for the path it names;
* ``results_inventory`` writing to a temporary directory: the same table
  rows (the generator line names the script).

Also: the npz copies of committed H5 results that the card machine (no
``h5py``) reads hold the same arrays.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from ode_uncertainty_tpu_torch import measure_scaling, report_estimation, results_inventory
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

REPO = Path(__file__).resolve().parent.parent


def _run_jax_script(args, home, timeout=300):
    env = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(home)}
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env, cwd=REPO / "scripts",
                         timeout=timeout)
    assert out.returncode == 0, f"{args} failed:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_measure_scaling_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    stdout = _run_jax_script(["measure_scaling.py", "--path", "host", "--devices", "1,2", "--per-device", "2"],
                             tmp_path)
    ref = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    monkeypatch.setattr(measure_scaling, "NUM_STEPS", 20)
    monkeypatch.setattr(measure_scaling, "MAX_ITER", 2)
    monkeypatch.setattr(measure_scaling, "REPS", 1)
    rows = measure_scaling.main(["--path", "host", "--devices", "1,2", "--per-device", "2", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == rows and [r["devices"] for r in rows] == [r["devices"] for r in ref] == [1, 2]
    for got, want in zip(rows, ref):
        assert set(want) <= set(got) and got["path"] == want["path"] and got["restarts"] == want["restarts"]
        assert got["cards"] == ["cpu"] and got["finite"]
        assert np.isfinite([got["wall_s"], got["partition_overhead"]]).all() and got["wall_s"] > 0
    assert rows[0]["partition_overhead"] == 1.0


def test_measure_scaling_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_scaling.shard_devices(2, "cuda")


def test_report_estimation_matches_the_jax_script(tmp_path, capsys):
    h5 = REPO / "results" / "params" / "lotkavolterra2.h5"
    ref = _run_jax_script(["report_estimation.py", "--experiment", "params/lotkavolterra2", "--set", "platform=cpu",
                           "--set", f"parameter_estimates_input={h5}"], tmp_path)
    report_estimation.main(build_config(load_experiment("params/lotkavolterra2"),
                                        {"parameter_estimates_input": str(h5)}))
    got = capsys.readouterr().out
    assert got == ref and "best restart" in got and "alpha" in got


def test_results_inventory_matches_the_jax_script(tmp_path, capsys):
    jax_out, port_out = tmp_path / "jax.md", tmp_path / "port.md"
    _run_jax_script(["results_inventory.py", "--out", str(jax_out)], tmp_path)
    text = results_inventory.main(["--out", str(port_out)])
    assert port_out.read_text() == text
    got, ref = text.splitlines(), jax_out.read_text().splitlines()
    table = lambda lines: [line for line in lines if line.startswith("|")]
    assert table(got) == table(ref) and len(table(got)) > 90
    assert got[2].split(" at ")[1].split("**")[1] == ref[2].split(" at ")[1].split("**")[1]  # the executed count


@pytest.mark.parametrize("npz, h5", [
    ("hodgkinhuxley11_full_result.npz", "params/hodgkinhuxley11_full.h5"),
    ("hodgkinhuxley_full.npz", "noise_gt/hodgkinhuxley_full.h5"),
], ids=["hh11_full_result", "hh_full_observations"])
def test_npz_copies_hold_the_committed_h5(npz, h5):
    with np.load(REPO / "ode_uncertainty_tpu_torch" / "data" / npz) as z, h5py.File(REPO / "results" / h5, "r") as f:
        keys = sorted(z.files)
        assert keys and set(keys) <= set(f)
        for key in keys:
            np.testing.assert_array_equal(z[key], f[key][()], err_msg=key)
