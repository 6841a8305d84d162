"""Probe of the NLL kernels on one NVIDIA GPU: what the compiled code is
made of and where a launch's time goes.

    python ode_uncertainty_tpu_torch/utils/kernel_probe.py [--root CHECKOUT] [--parts lv,erk,hh] [--out FILE]

``--root`` names the checkout whose package (and so whose ``csrc/``) is
probed, default the one this file is in, so one call can probe two trees
side by side. ``--parts`` picks the timings: ``lv`` (the Lotka-Volterra
kernels with the explicit RKF45 step), ``erk`` (every other explicit-step
instantiation: the tile models under every tableau) and ``hh`` (the
Kvaerno3 Hodgkin-Huxley ones), default ``lv,hh``. It prints one JSON object (also
written to ``--out``):

* ``sass``: for each NLL kernel of the built library (Lotka-Volterra and
  Hodgkin-Huxley, forward and gradient, each type and observation size),
  the static SASS instruction mix from ``cuobjdump -sass``: instructions in
  all, float32 and float64 arithmetic, IEEE division checks (``FCHK``),
  float64 reciprocal and square-root seeds (``MUFU.RCP64H``,
  ``MUFU.RSQ64H``), the other ``MUFU`` operations, local-memory loads and
  stores (``LDL``/``STL``, the spills), shared-memory loads and stores,
  shuffles, calls and branches;
* ``ptxas``: registers and spill bytes of every instantiation;
* ``times`` (``lv``): CUDA-event medians (ms) of launches on
  params/lotkavolterra2 (L = 1, 2000 RKF45 steps, a correct after every
  step) with synthesized observations: the forward at B = 1, 100, 256 and
  8192 in float32 and at B = 1 and 256 in float64; the same predicts with a
  correct every 10th step only, at B = 1 and 256 (the two split a step's
  time between predict and correct); the gradient at B = 1 and 256 on the
  2 optimized rows, without and with d/d gamma^1/2, in float32 and float64;
  and bench.py's `lv` shape (B = 8192, L = 2, a correct every 10th step);
* ``times`` (``erk``): each explicit-step instantiation of Lotka-Volterra
  (Heun-Euler, Bogacki-Shampine 3(2), Dormand-Prince 6(5)), Lorenz, van der
  Pol, the pendulum, logistic and exponential growth (every tableau), at
  L = 1 and L = n, float32 and float64, on a 1,000-step rig with a correct
  a step: the forward at B = 1 and 256, the gradient at B = 256 over every
  parameter row;
* ``times`` (``hh``): on params/hodgkinhuxley1_r4 at its full 10^4 steps:
  the forward at B = 1, 100 and 256, the forward with the Newton iterations
  cut to 0 and with a correct every 10th step only, the n = 8 forward at
  bench.py's hh_full shape (B = 512) and its gradient on the 11 rows, the
  gradient at B = 256 on g_Na (float32, with d/d gamma^1/2, float64), the
  forward on the B = 100 lanes repeated to wider batches (the same work per
  lane at every width); and on params/hodgkinhuxley7_full (n = 8) and
  6_r1 (n = 7), the forward and the gradient on the optimized rows at
  B = 256, float32 and float64, with the entry points' time rule;
* ``placement`` (``hh``): the SM each block of a launch of one-warp blocks
  ran on (a spinning probe kernel built here), as the number of distinct
  SMs and the most blocks on one SM, for the block counts the HH launches
  make;
* ``arith``: where the checkout's ``csrc/ekf_chain.cuh`` has the branch-free
  ``div_t`` and ``sqrt_t``, how many of 2^24 random operands (normal range,
  float32 and float64; and 0) give another result than the IEEE ``/`` and
  ``sqrt`` (a test kernel built here from that header);
* ``card``: nvidia-smi's name and power limit, the card every number of the
  report was measured on; ``clocks``: the same with the SM clock, read
  after the timings.

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
# Counts the operands where div_t / sqrt_t differ from the IEEE operations:
# random bit patterns mapped into the normal range (exponents -60..60), and 0.
ARITH_SRC = r"""
#include "ekf_chain.cuh"
namespace {  // beside ekf_chain.cuh's div_t: the global name is stdlib.h's type
__device__ unsigned long long mix(unsigned long long x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL; x ^= x >> 33;
  return x;
}
__device__ float f32_of(unsigned long long r) {
  const unsigned m = static_cast<unsigned>(r) & 0x7fffffu, e = 127u - 60u + static_cast<unsigned>((r >> 32) % 121u);
  return __uint_as_float((e << 23) | m) * ((r >> 40) & 1 ? -1.0f : 1.0f);
}
__device__ double f64_of(unsigned long long r) {
  const unsigned long long e = 1023ull - 60ull + (mix(r) % 121ull);
  return __longlong_as_double(static_cast<long long>((e << 52) | (r & 0xfffffffffffffull))) * ((r >> 60) & 1 ? -1.0 : 1.0);
}
__global__ void check(unsigned long long n, unsigned long long* bad) {
  const unsigned long long i = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const unsigned long long r1 = mix(2 * i + 1), r2 = mix(2 * i + 2);
  const float a = f32_of(r1), b = f32_of(r2);
  if (__float_as_uint(div_t(a, b)) != __float_as_uint(a / b)) atomicAdd(bad + 0, 1ull);
  if (__float_as_uint(sqrt_t(fabsf(a))) != __float_as_uint(sqrtf(fabsf(a)))) atomicAdd(bad + 1, 1ull);
  const double c = f64_of(r1), d = f64_of(r2);
  if (__double_as_longlong(div_t(c, d)) != __double_as_longlong(c / d)) atomicAdd(bad + 2, 1ull);
  if (__double_as_longlong(sqrt_t(::fabs(c))) != __double_as_longlong(::sqrt(::fabs(c)))) atomicAdd(bad + 3, 1ull);
  if (i == 0) bad[4] = sqrt_t(0.0f) == 0.0f && sqrt_t(0.0) == 0.0 ? 0 : 1;
}
}  // namespace
extern "C" int run_check(unsigned long long n, unsigned long long* bad) {
  check<<<static_cast<unsigned>((n + 255) / 256), 256>>>(n, bad);
  return (int)cudaDeviceSynchronize();
}
"""


def _nvcc_lib(nvcc: str, build_dir: Path, name: str, src_text: str, include: Path = None) -> ctypes.CDLL:
    build_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = build_dir / f"{name}.cu", build_dir / f"lib{name}.so"
    src.write_text(src_text)
    inc = ["-I", str(include)] if include else []
    done = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC", *inc, "-o", str(lib_path), str(src)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib_path))


def placement(nvcc: str, build_dir: Path) -> dict:
    """Distinct SMs and the most blocks on one SM for launches of one-warp
    blocks that spin ~1 ms each (all resident at once)."""
    import torch

    lib = _nvcc_lib(nvcc, build_dir, "placement", PLACEMENT_SRC)
    lib.launch_where.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
    out = {}
    for blocks in (13, 32, 64, 128):
        sm = torch.full((blocks,), -1, dtype=torch.int32, device="cuda")
        if lib.launch_where(blocks, sm.data_ptr(), 2_000_000) != 0:
            raise RuntimeError("placement probe failed")
        counts = collections.Counter(sm.tolist())
        out[blocks] = {"distinct_sms": len(counts), "most_blocks_on_one_sm": max(counts.values())}
    return out


def arith(nvcc: str, build_dir: Path, csrc: Path) -> dict:
    """Operands on which div_t and sqrt_t differ from IEEE / and sqrt."""
    import torch

    if "sqrt_t" not in (csrc / "ekf_chain.cuh").read_text():
        return {"skipped": "no sqrt_t in this checkout"}
    lib = _nvcc_lib(nvcc, build_dir, "arith", ARITH_SRC, csrc)
    lib.run_check.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p]
    n = 1 << 24
    bad = torch.zeros(5, dtype=torch.int64, device="cuda")
    if lib.run_check(n, bad.data_ptr()) != 0:
        raise RuntimeError("arithmetic check failed to run")
    b = bad.tolist()
    return {"operands": n, "div_t_f32_differs": b[0], "sqrt_t_f32_differs": b[1], "div_t_f64_differs": b[2],
            "sqrt_t_f64_differs": b[3], "sqrt_t_of_0_is_0": b[4] == 0}


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--parts", default="lv,hh", help="comma-separated: lv, erk, hh")
    ap.add_argument("--out", default=None)
    return ap.parse_args()


def kernel_label(mangled: str) -> str:
    """A readable name for a mangled NLL kernel: kernel, model and tableau,
    n, L, type (the template arguments as chip_smoke.ptxas_report reads
    them)."""
    import chip_smoke

    m = re.search(r"(nll_(?:fwd|bwd))(_team)?_kernelI([fd])(.*)", mangled)
    kernel, team, real, rest = m.group(1, 2, 3, 4)
    names = [rest[k.end():k.end() + int(k.group(1))] for k in re.finditer(r"NS_(\d+)", rest)]
    model = next(chip_smoke.PTXAS_MODELS[x] for x in names if x in chip_smoke.PTXAS_MODELS)
    # a checkout before the team kernels took a tableau ran Kvaerno3 on them
    tableau = next((chip_smoke.PTXAS_TABLEAUS[x] for x in names if x in chip_smoke.PTXAS_TABLEAUS), "kvaerno3")
    if team:  # <T, Model, L, Tab> (<T, HodgkinHuxley<n>> before), Model HodgkinHuxley<n> or a tile model
        hh = re.search(r"HodgkinHuxleyILi(\d+)E", rest)
        n = hh.group(1) if hh else chip_smoke.TILE_N[model]
        obs = re.search(r"Li(\d+)E", rest[hh.end():] if hh else rest)
        obs = obs.group(1) if obs else "1"
    else:  # thread per lane: <T, N, L, Model, Tab>
        n, obs = re.match(r"Li(\d+)ELi(\d+)E", rest).group(1, 2)
    return f"{kernel}{' team' if team else ''} {model}/{tableau} n={n} L={obs} {'f32' if real == 'f' else 'f64'}"


def sass_mix(lib_path: Path, cuobjdump: str) -> dict:
    """Static instruction counts of each NLL kernel in the library."""
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    out = {}
    name, counts = None, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_label(m.group(1)) if re.search(r"nll_(fwd|bwd)", m.group(1)) else None
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


def variant(fn, **changes):
    """The forward wrapper on a changed chain (the rig constants rebuilt)."""
    from ode_uncertainty_tpu_torch.ops import nll_kernel

    cm = dataclasses.replace(fn.cm, **{k: v for k, v in changes.items() if k != "newton_iters"})
    out = nll_kernel.NllFwd(cm, fn.spec, fn.ys)
    if "newton_iters" in changes:
        vals = cm.rig_doubles()
        vals[6] = float(changes["newton_iters"])
        out._rig = (ctypes.c_double * len(vals))(*vals)
        out.grad._rig = out._rig
    return out


def median_ms(launch) -> float:
    import numpy as np
    import torch

    import chip_smoke

    launch()
    torch.cuda.synchronize()
    return float(np.median(chip_smoke.event_times(launch, REPS)))


def lv_times() -> tuple:
    """The Lotka-Volterra kernels on params/lotkavolterra2 and bench.py's lv."""
    import torch

    import chip_smoke
    from ode_uncertainty_tpu_torch.run_parameter_estimation import gammas_of

    dev = chip_smoke.DEVICE
    out_dir = chip_smoke.OUT
    out_dir.mkdir(exist_ok=True)
    obs = out_dir / "probe_lv2_observations.npz"
    chip_smoke.synthesize_observations(obs)
    cfg = chip_smoke.lv2_config(obs, out_dir / "probe_lv2.npz")
    gs0 = float(torch.sqrt(gammas_of(cfg, torch.float64)[0]))
    k32, k64 = chip_smoke.lv2_kernel(cfg, torch.float32), chip_smoke.lv2_kernel(cfg, torch.float64)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    for b in (1, 100, 256, 8192):
        p = torch.rand((b, 2), generator=gen, dtype=torch.float32, device=dev)
        phys, phys64 = k32.physical(p), k64.physical(p.double())
        times[f"fwd_lv2_f32_B{b}"] = median_ms(lambda: k32.launch(phys, gs0))
        if b in (1, 256):
            times[f"fwd_lv2_f64_B{b}"] = median_ms(lambda: k64.launch(phys64, gs0))
            sparse = variant(k32, d=10, n_obs=k32.cm.n_obs // 10)
            times[f"fwd_lv2_f32_B{b}_correct_every_10"] = median_ms(lambda: sparse.launch(phys, gs0))
            g, g64 = torch.ones(b, dtype=torch.float32, device=dev), torch.ones(b, dtype=torch.float64, device=dev)
            for dg in (False, True):
                tag = "_dgamma" if dg else ""
                times[f"bwd_lv2_f32_B{b}_2dir{tag}"] = median_ms(
                    lambda: k32.grad.launch(phys, gs0, g, dg, k32.opt_rows))
                times[f"bwd_lv2_f64_B{b}_2dir{tag}"] = median_ms(
                    lambda: k64.grad.launch(phys64, gs0, g64, dg, k64.opt_rows))
    kb = chip_smoke.bench_lv_kernel(torch.float32)
    pb = torch.rand((8192, 2), generator=gen, dtype=torch.float32, device=dev)
    physb = kb.physical(pb)
    times["fwd_bench_lv_f32_B8192"] = median_ms(lambda: kb.launch(physb, 0.1))
    shape = {"lv2_steps": k32.cm.first + 1 + (k32.cm.n_obs - 1) * k32.cm.d, "lv2_corrects": k32.cm.n_obs,
             "lv2_gamma_sqrt": gs0, "bench_lv_corrects": kb.cm.n_obs, "bench_lv_gamma_sqrt": 0.1}
    return times, shape


def hh_times(root: Path) -> tuple:
    """The Kvaerno3 kernels on params/hodgkinhuxley1_r4, bench.py's hh_full
    (forward and gradient) and the n = 7 / n = 8 gradients at an optimize
    dispatch of params/hodgkinhuxley6_r1 and 7_full."""
    import torch

    import chip_smoke
    from ode_uncertainty_tpu_torch.ops import nll_kernel
    from ode_uncertainty_tpu_torch.run_parameter_estimation import build_rig, gammas_of
    from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment

    data = root / "ode_uncertainty_tpu_torch" / "data" / "hodgkinhuxley_r4.npz"
    cfg = build_config(load_experiment("params/hodgkinhuxley1_r4"), {"y_path": str(data), "device": "cuda"})
    gs0 = float(torch.sqrt(gammas_of(cfg, torch.float64)[0]))

    def kernel(dtype):
        rig = build_rig(cfg, dtype, torch.device("cuda"))
        return nll_kernel.make_nll_cuda(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0,
                                        rig.num_steps, rig.q_sqrt)

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
    gb = torch.ones(512, dtype=torch.float32, device="cuda")
    times["bwd_hh8_f32_B512_11dir"] = median_ms(lambda: kb.grad.launch(physb, 0.1, gb, False, kb.opt_rows))
    # the n = 7 and n = 8 gradients at an optimize dispatch of 256 lanes on
    # the optimized rows of params/hodgkinhuxley6_r1 and 7_full
    for experiment, data, n in (("params/hodgkinhuxley7_full", "hodgkinhuxley_full.npz", 8),
                                ("params/hodgkinhuxley6_r1", "hodgkinhuxley_r1.npz", 7)):
        hcfg = chip_smoke.hh_config(experiment, data)
        for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
            rig = build_rig(hcfg, dtype, torch.device("cuda"))
            kn = nll_kernel.make_nll_cuda(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0,
                                          rig.num_steps, rig.q_sqrt, accumulate_time=True)
            pn = torch.rand((256, kn.spec.num_opt), generator=gen, dtype=torch.float32, device="cuda").to(dtype)
            physn, gn = kn.physical(pn), torch.ones(256, dtype=dtype, device="cuda")
            rows = len(kn.opt_rows)
            times[f"bwd_hh{n}_{label}_B256_{rows}dir"] = median_ms(
                lambda: kn.grad.launch(physn, gs0, gn, False, kn.opt_rows))
            times[f"fwd_hh{n}_{label}_B256"] = median_ms(lambda: kn.launch(physn, gs0))
    return times, {"hh4_steps": k32.cm.n_obs, "hh4_gamma_sqrt": gs0}


def erk_times() -> tuple:
    """Every explicit-step instantiation of the other tile models and
    tableaus (chip_smoke.erk_chains) on its timing rig: 1,000 steps, a
    correct a step (params/pendulum's shape), gamma^1/2 = 0.1; the forward
    at B = 1 and 256, the gradient at B = 256 over every row."""
    import numpy as np
    import torch

    import chip_smoke

    times = {}
    for model, tab, L in chip_smoke.erk_chains():
        for dtype, label in ((torch.float32, "f32"), (torch.float64, "f64")):
            kern = chip_smoke.erk_kernel(model, tab, L, dtype, chip_smoke.ERK_TIMING_STEPS, 1)
            p = torch.as_tensor(np.random.default_rng(0).uniform(size=(256, kern.spec.num_opt)), dtype=dtype,
                                device=chip_smoke.DEVICE)
            phys, g = kern.physical(p), torch.ones(256, dtype=dtype, device=chip_smoke.DEVICE)
            phys1 = phys[:, :1].contiguous()
            name = f"{model}_{tab}_L{L}_{label}"
            times[f"fwd_{name}_B1"] = median_ms(lambda: kern.launch(phys1, 0.1))
            times[f"fwd_{name}_B256"] = median_ms(lambda: kern.launch(phys, 0.1))
            times[f"bwd_{name}_B256_{kern.cm.k_params}dir"] = median_ms(lambda: kern.grad.launch(phys, 0.1, g, False))
    return times, {"erk_steps": chip_smoke.ERK_TIMING_STEPS, "erk_gamma_sqrt": 0.1}


def main() -> int:
    args = _args()
    root = Path(args.root).resolve()
    parts = set(args.parts.split(","))
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ode_uncertainty_tpu_torch.utils import cuda_build

    import chip_smoke  # the checkout's own ptxas parser and rigs

    chip_smoke.DEVICE = "cuda"
    smi = lambda q: subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                                   capture_output=True, text=True, check=True).stdout.strip()
    res = cuda_build.build_library()
    cuobjdump = str(Path(cuda_build.nvcc_path()).with_name("cuobjdump"))
    report = {"root": str(root), "card": smi("name,power.limit"), "nvcc_seconds": res.seconds,
              "ptxas": chip_smoke.ptxas_report(res.log), "sass": sass_mix(res.path, cuobjdump),
              "arith": arith(cuda_build.nvcc_path(), root / "build" / "probe", root / "ode_uncertainty_tpu_torch" / "csrc"),
              "times": {}, "shape": {"reps": REPS}}
    if "lv" in parts:
        times, shape = lv_times()
        report["times"].update(times)
        report["shape"].update(shape)
    if "erk" in parts:
        times, shape = erk_times()
        report["times"].update(times)
        report["shape"].update(shape)
    if "hh" in parts:
        times, shape = hh_times(root)
        report["times"].update(times)
        report["shape"].update(shape)
        report["placement"] = placement(cuda_build.nvcc_path(), root / "build" / "probe")
    report["clocks"] = smi("name,power.limit,clocks.sm,clocks.max.sm")
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
