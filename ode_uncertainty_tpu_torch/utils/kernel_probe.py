"""Probe of the Kvaerno3 NLL kernels on one NVIDIA GPU: what the compiled
code is made of and where a launch's time goes.

    python ode_uncertainty_tpu_torch/utils/kernel_probe.py [--root CHECKOUT] [--out FILE]

``--root`` names the checkout whose package (and so whose ``csrc/``) is
probed, default the one this file is in, so one call can probe two trees
side by side. It prints one JSON object (also written to ``--out``):

* ``sass``: for each Hodgkin-Huxley kernel of the built library, the static
  SASS instruction mix from ``cuobjdump -sass``: instructions in all, float32
  and float64 arithmetic, IEEE division checks (``FCHK``), float64
  reciprocal and square-root seeds (``MUFU.RCP64H``, ``MUFU.RSQ64H``), the
  other ``MUFU`` operations, local-memory loads and stores (``LDL``/``STL``,
  the spills), shared-memory loads and stores, shuffles, calls and branches;
* ``ptxas``: registers and spill bytes of every instantiation;
* ``times``: CUDA-event medians (ms) of launches on params/hodgkinhuxley1_r4
  at its full 10^4 steps: the forward at B = 1, 100 and 256, the forward with
  the Newton iterations cut to 0 and with a correct every 10th step only
  (the same predicts; these two split a step's time between its parts), the
  n = 8 forward at bench.py's hh_full shape (B = 512), and the gradient at
  B = 256 on g_Na (float32, with d/d gamma^1/2, float64);
* ``times`` also holds the forward on the B = 100 lanes repeated to wider
  batches (the same work per lane at every width);
* ``placement``: the SM each block of a launch of one-warp blocks ran on
  (a spinning probe kernel built here), as the number of distinct SMs and
  the most blocks on one SM, for the block counts the HH launches make;
* ``clocks``: nvidia-smi's SM clock, power limit and name, read after the
  timings.

It needs a card and nvcc; without them it exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

REPS = 5
PLACEMENT_SRC = r"""
extern "C" __global__ void where(int* out, long long spin) {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  if (threadIdx.x == 0) out[blockIdx.x] = s;
  const long long t0 = clock64();
  while (clock64() - t0 < spin) {}
}
extern "C" int launch_where(int blocks, int* out, long long spin) {
  where<<<blocks, 32>>>(out, spin);
  return (int)cudaDeviceSynchronize();
}
"""


def placement(nvcc: str, build_dir: Path) -> dict:
    """Distinct SMs and the most blocks on one SM for launches of one-warp
    blocks that spin ~1 ms each (all resident at once)."""
    import torch

    build_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = build_dir / "placement.cu", build_dir / "libplacement.so"
    src.write_text(PLACEMENT_SRC)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O2", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.launch_where.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
    out = {}
    for blocks in (13, 32, 64, 128):
        sm = torch.full((blocks,), -1, dtype=torch.int32, device="cuda")
        if lib.launch_where(blocks, sm.data_ptr(), 2_000_000) != 0:
            raise RuntimeError("placement probe failed")
        counts = collections.Counter(sm.tolist())
        out[blocks] = {"distinct_sms": len(counts), "most_blocks_on_one_sm": max(counts.values())}
    return out


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out", default=None)
    return ap.parse_args()


def sass_mix(lib_path: Path, cuobjdump: str) -> dict:
    """Static instruction counts of each Hodgkin-Huxley kernel in the library."""
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    out = {}
    name, counts = None, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "HodgkinHuxley" in m.group(1) else None
            counts = collections.Counter() if name else None
            if name:
                out[name] = counts
            continue
        if counts is None:
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            op = m.group(1)
            base = op.split(".")[0]
            counts["instructions"] += 1
            counts[base] += 1
            if base == "MUFU":
                counts[op] += 1
    keys = ("instructions", "FFMA", "FMUL", "FADD", "DFMA", "DMUL", "DADD", "FCHK", "MUFU", "MUFU.RCP",
            "MUFU.RCP64H", "MUFU.RSQ", "MUFU.RSQ64H", "MUFU.SQRT", "MUFU.EX2", "MUFU.LG2", "LDL", "STL",
            "LDS", "STS", "SHFL", "CALL", "BRA", "WARPSYNC", "NOP")
    return {k: {key: int(c.get(key, 0)) for key in keys} for k, c in out.items()}


def main() -> int:
    args = _args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ode_uncertainty_tpu_torch.ops import nll_kernel
    from ode_uncertainty_tpu_torch.run_parameter_estimation import build_rig, gammas_of
    from ode_uncertainty_tpu_torch.utils import cuda_build
    from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

    import chip_smoke  # the checkout's own ptxas parser and hh_full rig

    chip_smoke.DEVICE = "cuda"
    res = cuda_build.build_library()
    cuobjdump = str(Path(cuda_build.nvcc_path()).with_name("cuobjdump"))
    report = {"root": str(root), "nvcc_seconds": res.seconds, "ptxas": chip_smoke.ptxas_report(res.log),
              "sass": sass_mix(res.path, cuobjdump)}

    data = root / "ode_uncertainty_tpu_torch" / "data" / "hodgkinhuxley_r4.npz"
    cfg = build_config(load_experiment("params/hodgkinhuxley1_r4"), {"y_path": str(data), "device": "cuda"})
    gs0 = float(torch.sqrt(gammas_of(cfg, torch.float64)[0]))

    def kernel(dtype):
        rig = build_rig(cfg, dtype, torch.device("cuda"))
        return nll_kernel.make_nll_cuda(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0,
                                        rig.num_steps, rig.q_sqrt)

    def variant(fn, **changes):
        """The wrapper on a changed chain (the rig constants are rebuilt)."""
        cm = dataclasses.replace(fn.cm, **{k: v for k, v in changes.items() if k != "newton_iters"})
        out = nll_kernel.NllFwd(cm, fn.spec, fn.ys)
        if "newton_iters" in changes:
            vals = cm.rig_doubles()
            vals[6] = float(changes["newton_iters"])
            out._rig = (ctypes.c_double * len(vals))(*vals)
            out.grad._rig = out._rig
        return out

    def median_ms(launch) -> float:
        launch()
        torch.cuda.synchronize()
        return float(np.median(chip_smoke.event_times(launch, REPS)))

    k32, k64 = kernel(torch.float32), kernel(torch.float64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for b in (1, 100, 256):
        p = torch.rand((b, 1), generator=gen, dtype=torch.float32, device="cuda")
        phys = k32.physical(p)
        times[f"fwd_hh4_f32_B{b}"] = median_ms(lambda: k32.launch(phys, gs0))
        if b == 100:
            no_newton = variant(k32, newton_iters=0)
            times["fwd_hh4_f32_B100_newton0"] = median_ms(lambda: no_newton.launch(phys, gs0))
            sparse = variant(k32, d=10, n_obs=k32.cm.n_obs // 10)
            times["fwd_hh4_f32_B100_correct_every_10"] = median_ms(lambda: sparse.launch(phys, gs0))
        if b == 256:
            g = torch.ones(b, dtype=torch.float32, device="cuda")
            times["bwd_hh4_f32_B256_1dir"] = median_ms(lambda: k32.grad.launch(phys, gs0, g, False, k32.opt_rows))
            times["bwd_hh4_f32_B256_1dir_dgamma"] = median_ms(
                lambda: k32.grad.launch(phys, gs0, g, True, k32.opt_rows))
            phys64, g64 = k64.physical(p.double()), g.double()
            times["bwd_hh4_f64_B256_1dir"] = median_ms(
                lambda: k64.grad.launch(phys64, gs0, g64, False, k64.opt_rows))
            times["fwd_hh4_f64_B256"] = median_ms(lambda: k64.launch(phys64, gs0))
    base = torch.rand((100, 1), generator=gen, dtype=torch.float32, device="cuda")
    for b in (100, 128, 192, 256, 512):
        phys = k32.physical(base.repeat((b + 99) // 100, 1)[:b])
        times[f"fwd_hh4_f32_tiled_B{b}"] = median_ms(lambda: k32.launch(phys, gs0))
    kb = chip_smoke.hh_bench_kernel(torch.float32)
    pb = torch.rand((512, kb.spec.num_opt), generator=gen, dtype=torch.float32, device="cuda")
    physb = kb.physical(pb)
    times["fwd_hh8_f32_B512"] = median_ms(lambda: kb.launch(physb, 0.1))
    report["times"] = times
    report["placement"] = placement(cuda_build.nvcc_path(), root / "build" / "probe")
    report["shape"] = {"steps": k32.cm.n_obs, "gamma_sqrt": gs0, "reps": REPS}
    report["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
