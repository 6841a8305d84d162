"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line with its own wall seconds:

  1. device       nvidia-smi name and power limit; fails without CUDA.
  2. build        nvcc builds csrc/*.cu into build/ (one nvcc per source, in
                  parallel, then a link; timed). Before it the observations
                  of phase 5 are synthesized (phase observations), and the
                  processes of the LV plain references (phases 3 and 4)
                  and of the erk ones (phases 18-21) start, to run beside
                  the build.
  3. parity       the nll_fwd kernel against its plain PyTorch version (run in
                  float64 on the host's CPU, in PLAIN_REF_GROUPS processes, on
                  the same inputs) at the full 2000-step horizon, for
                  gamma^1/2 = 0.1 and
                  gamma = 0, on the params/lotkavolterra2 rig (L = 1) and the
                  bench.py LV rig (L = 2): float64 kernel vs float64 plain
                  (rtol 1e-9) and float32 kernel vs float64 plain (p99 of the
                  lane-normalized error |k - p| / (|p| + 1) <= 2e-4). Lanes that
                  are not finite must coincide.
  4. grad parity  the nll_bwd kernel against its plain version (autograd
                  through the plain forward, on the host's CPU as in phase 3)
                  on 256 lanes, half at gamma^1/2 = 0.1 and half at 0, every
                  parameter row and each lane's d/d gamma^1/2: the
                  lotkavolterra2 rig at its full 2000 steps, the bench.py LV
                  rig cut to 400 steps (the plain gradient takes ~45 s per
                  2000 steps on the card). float64 kernel vs float64
                  plain: max relative error <= 1e-8 (an element whose plain value
                  is 0 relative to the largest); float32 kernel vs float64
                  plain: p99 of the lane-normalized error <= 5e-3 (the gradient
                  rtol of tests/test_pallas_ekf.py), max reported; no
                  non-finite value on either side.
  5. main path    the port's `evaluate` on params/lotkavolterra2 (20 x 20 grid,
                  4 tempering stages, float32) with the launch counts set to 0
                  just before; observations are synthesized (RKF45 solve at the
                  default parameters, one point per step, noise of variance 0.1
                  from numpy's default_rng(seed)). Checks shape, finiteness,
                  launches > 0 and 64 grid points against the float64 plain
                  version.
  6. optimize     the port's `optimize` on params/lotkavolterra2 at full width
                  (100 restarts from a seeded torch.Generator, 4 tempering
                  stages, 2000 steps, float32, lbfgs_maxiter 200) on the same
                  observations, the counts set to 0 just before. Checks that
                  both kernels ran, that >= 95% of restarts end finite, that the
                  best final NLL is at most the NLL at the generating
                  parameters (gamma = 0, same kernel) plus 1e-3 relative, and
                  that the best optimum is within 10% of the generating alpha
                  and beta. Prints each stage's wall time, dispatches and the
                  lanes still active at the iteration limit, and the device
                  time of every kernel launch (CUDA events around each): the
                  kernels' share of the wall time.
  7. timing       one nll_fwd launch of evaluate's shape and one nll_bwd launch
                  at optimize's widest dispatch on its optimized rows, each the
                  median of 7 CUDA-event timings, beside its bound and its plain
                  version's time at a cut horizon of PLAIN_TIMING_STEPS (100); each also at
                  B = 1 (one lane, the width of optimize's stragglers); the
                  nll_bwd launch also over every row, with d/d gamma^1/2 and in
                  float64.
  8. throughput   bench.py's `lv` workload: B = 8192, 2000 steps, H = I,
                  an observation every 10 steps, float32, gamma = 0.01; median
                  of CUDA-event-timed launches; the plain version once at
                  B = 1024, PLAIN_TIMING_STEPS steps.
  9. hh_parity    the Kvaerno3 nll_fwd (float64 and float32) against its float64
                  plain version (on the host's CPU) on Hodgkin-Huxley rigs with
                  the committed observations, 256 lanes, half at the first
                  stage's gamma^1/2 and half at 0: reduced-4 (200 steps) and
                  full (50 steps) across the stimulus onset (t0 = 9.9, rest
                  state, g_Na varied), reduced-4 through the first spike (x0:
                  the port's float64 Kvaerno3 solve at t = 23.5, 200 steps);
                  float64 rtol 1e-9, float32 p99 <= 5e-4. Full over
                  hodgkinhuxley7_full's seven parameters on 64 lanes (50
                  steps): float64 held, float32 reported.
 10. hh_full_horizon  params/hodgkinhuxley1_r4 at its 10^4 steps on
                  evaluate's grid: float32 kernel against float64 kernel (p99
                  <= 5e-4), both on the step-index time rule (the tiles'),
                  under which both types switch the stimulus on and off at
                  the same steps; and the float64 gap between that rule and
                  the running sum t += h (`accumulate_time`), the rule the
                  entry points run (the JAX CLI's XLA make_nll).
 11. hh_main_path the port's `evaluate` on params/hodgkinhuxley1_r4 (10^4 steps,
                  100 x 4 grid, float32) on the committed npz observations,
                  counts set to 0 just before: 4 launches, shape, finiteness,
                  8 grid points equal bit for bit to a direct float32 launch
                  built with `accumulate_time` (the wiring), their gap to the
                  float64 kernel under the same rule reported (the
                  reference's own float32 edge steps; the precision check is
                  hh_full_horizon's), the last stage's argmin in g_Na within
                  10% of 25.0.
 12. hh_timing    the Kvaerno3 nll_fwd at evaluate's shape (f32, f64), at
                  optimize's widest dispatch (B = 256, f32) and at bench.py's
                  hh_full shape (B = 512, n = 8, 10^4 steps, f32), median of
                  7, beside the operation bound and the plain version at a
                  cut horizon of HH_PLAIN_TIMING_STEPS (5) steps.
 13. hh_grad_parity  the Kvaerno3 nll_bwd (float64 and float32) against its
                  float64 plain version (on the host's CPU) on the 200-step
                  reduced-4 onset (t0 = 9.9) and spike (t0 = 23.5) rigs, 64
                  lanes, half at the first stage's gamma^1/2 and half at 0,
                  g_Na varied, every parameter row and each lane's
                  d/d gamma^1/2: float64 max relative error <= 1e-8, float32
                  p99 of the lane-normalized error <= 1e-2 (the implicit
                  gradient rtol of tests/test_pallas_ekf.py:319); and a launch
                  over the optimized rows alone against one over every row.
                  The same for the n = 7 and n = 8 units on onset rigs of
                  HH_FULL_GRAD_RIG_STEPS steps (t0 = 9.9, rest state):
                  reduced-1 (params/hodgkinhuxley6_r1's model on the committed
                  reduced-1 observations) and full, g_Na varied: float64 as
                  above; float32 held on g_Na and d/d gamma^1/2 (p99 <=
                  1e-2), every row reported beside the float32 plain
                  gradient's own distance to the float64 one, and the
                  float32 kernel held to the float32 plain gradient on every
                  row (p99 <= 1e-2): float32 arithmetic itself reaches the
                  limit on rows these rigs do not vary. Full over
                  hodgkinhuxley7_full's seven parameters: float64 held,
                  float32 reported against both plain gradients (as
                  hh_parity's box rig); a lane whose NLL diverges there is
                  non-finite alike on both sides.
 14. hh_grad_full_horizon  params/hodgkinhuxley1_r4 at its 10^4 steps on 8
                  points of evaluate's grid at every stage: the float64
                  kernel gradient in g_Na against central differences of the
                  float64 nll_fwd (relative step 1e-7, lane-normalized error
                  <= 1e-4), and the float32 kernel gradient against the
                  float64 one (p99 <= 1e-2, held at the stages listed in
                  HH_GRAD_F32_HELD_STAGES, reported at every stage). The same
                  float64 check on params/hodgkinhuxley7_full (n = 8, the
                  entry points' time rule) at its 10^4 steps, g_Na at 0.8,
                  0.9, 1.1 and 1.2 times 25.0, the other six rows at their
                  defaults.
 15. hh_optimize  the port's `optimize` on params/hodgkinhuxley1_r4 at full
                  width (100 restarts, 4 stages, 10^4 steps, float32,
                  lbfgs_maxiter HH_LBFGS_MAXITER) on the committed npz
                  observations, the counts set to 0 just before: shape, both
                  kernels launched, >= 95% of restarts finite, the best final
                  NLL at most the generating parameters' (gamma = 0, same
                  kernel) plus 1e-3 relative, the best g_Na within 10% of
                  25.0; wall time, dispatches per stage, the widest dispatch,
                  and the device time of every kernel launch (CUDA events
                  around each): the kernels' share of the wall time.
 16. hh_full_optimize  the port's `optimize` on params/hodgkinhuxley7_full
                  (HH full, n = 8, 7 optimized rows, 100 restarts, 4 stages,
                  10^4 steps, float32, lbfgs_maxiter HH_FULL_LBFGS_MAXITER)
                  on the committed npz observations, the counts set to 0 just
                  before: shapes, both kernels launched and the route, >= 95%
                  of restarts finite, and at every stage the best final NLL at
                  most that stage's best starting NLL (the same wrapper at the
                  points each stage started from). Reported, not held: the
                  NLL at the generating parameters (gamma = 0, same wrapper)
                  beside the best final NLL, and the best optimum's relative
                  error per parameter: at this cut depth, recovering seven
                  parameters is not a fair check. Wall time, dispatches per
                  stage, the widest dispatch and the kernels' share as in
                  hh_optimize.
 17. hh_grad_timing  one Kvaerno3 nll_bwd launch at hh_optimize's widest
                  dispatch, median of 7: float32 on the optimized row, with
                  d/d gamma^1/2, and in float64 without and with it; beside
                  the bound and the plain gradient at a cut horizon of 5
                  steps. The n = 8 gradient at hh_full_optimize's widest
                  dispatch on its 7 rows (float32 and float64) and at
                  bench.py's hh_full shape (B = 512, 11 rows, float32),
                  median of HH_FULL_TIMING_REPS (1), each beside its bound
                  and its plain version at HH_N8_PLAIN_TIMING_STEPS steps.
 18. erk_parity   every explicit-step instantiation of the other tile models
                  and tableaus (Heun-Euler, Bogacki-Shampine 3(2), RKF45,
                  Dormand-Prince 6(5) on Lotka-Volterra (not RKF45), Lorenz,
                  van der Pol, the pendulum, logistic and exponential
                  growth, at every L in 1..n; 42 chains, 168
                  instantiations), nll_fwd and nll_bwd (every parameter row
                  and each lane's d/d gamma^1/2), float64 and float32,
                  against the float64 plain version on the host's CPU, on
                  rigs of ERK_PARITY_STEPS (50) steps with a correct every
                  second step (observations synthesized from an RKF45 solve
                  at the defaults plus N(0, 0.1)), every parameter varied
                  over 0.5-1.5 times its default, batches of 1, 33 and 256
                  lanes at gamma^1/2 = 0.1 and 0: float64 values rtol 1e-9,
                  gradients 1e-8; float32 p99 of the lane-normalized error
                  2e-4 and 5e-3. Its plain references (and the timing rigs'
                  operation counts) run in ERK_REF_GROUPS processes started
                  before the build (~50 s of host work on one core).
 19. pendulum_optimize  the port's `optimize` on params/pendulum with the
                  covariance-free filter (the kernels' configuration):
                  RKF45, 1,000 steps, length in [0.1, 10], 100 restarts x 4
                  stages, float32, the experiment's lbfgs_maxiter (200), on
                  the npz copy of results/noise_gt/pendulum.h5, the counts
                  set to 0 just before: the route, both kernels launched,
                  >= 95% of restarts finite, the best final NLL at most the
                  NLL at length 3.0 (the default that generated the
                  observations; gamma = 0, the same wrapper) plus 1e-3
                  relative, the best length within 10% of 3.0; and the
                  entry points' float64 wrapper on PENDULUM_LANES lanes at
                  the full horizon (value and gradient, the first and last
                  stage's gamma^1/2) against the float64 plain version on
                  the host's CPU (1e-9, 1e-8).
 20. pendulum_evaluate  the port's `evaluate` on the same experiment (100
                  lengths x 4 stages, float32) under each of the four
                  tableaus, the counts set to 0 just before each: 4 launches
                  of that tableau's instantiation, the last stage's argmin
                  within 10% of 3.0, every point equal bit for bit to a
                  direct launch of the entry points' wrapper.
 21. erk_full_horizon  Lorenz (L = 1 and 3, 5,000 steps) and van der Pol
                  (L = 1 and 2, 7,000 steps from t0 = 10) on the committed
                  results/noise_gt traces (npz copies) at full horizon in
                  float64 under every tableau, 16 lanes at 0.9-1.1 times the
                  defaults, half at gamma^1/2 = 0.1 and half at 0: every
                  value finite; on the first ERK_FULL_PREFIX_STEPS (50)
                  steps (Lorenz is chaotic) against the float64 plain
                  version on the host's CPU at 1e-9.
 22. erk_timing   every new instantiation at B = 256 over 1,000 steps with a
                  correct a step (params/pendulum's shape), median of 3
                  CUDA-event timings, nll_bwd over every parameter row;
                  beside each its bound (the operations one lane of the
                  plain version counts on that rig, counted in the erk
                  reference processes) and its plain version at
                  ERK_PLAIN_TIMING_STEPS (2) steps. The kernels line lists
                  every instantiation under rows 1 and 3 (`instantiations`:
                  launches on the paths of phases 19-21, ms, bound,
                  registers and spill stores from ptxas, the max_abs_err of
                  erk_parity's float32 lanes).
 22a. team_parity  every team instantiation beside HH x Kvaerno3
                  (Kvaerno3 on every tile model at every L in 1..n; each
                  single-compartment HH
                  variant under the four explicit tableaus at L = 1; 23
                  chains, 92 instantiations), nll_fwd and nll_bwd (every
                  row and d/d gamma^1/2), float64 and float32, against the
                  float64 plain version on the host's CPU: the tile models
                  on erk_parity's rigs at TEAM_TILE_STEPS (50), HH on its
                  experiment's rig and observations over TEAM_HH_STEPS (6)
                  from t0 = 9.98 (the stimulus edge inside), batches of 1,
                  33 and 256 at gamma^1/2 = 0.1 and 0: float64 1e-9 /
                  1e-8; float32 p99 5e-4 / 1e-2 (Kvaerno3) and 2e-4 / 5e-3
                  (explicit). Its plain references run in TEAM_REF_GROUPS
                  processes started after the build.
 22b. lv_kv3_optimize  `optimize` on params/lotkavolterra2 with
                  solver_builder Kvaerno3 (h = 0.01), nothing cut: the route
                  and its two instantiations alone, >= 95% finite, the best
                  NLL at most the generating parameters' plus 1e-3
                  relative, (alpha, beta) within 10%; LVKV3_LANES float64
                  lanes at full horizon against the plain version on the
                  host's CPU (1e-9, 1e-8).
 22c. lv_kv3_evaluate  `evaluate` on the same (20 x 20 x 4): shape, finite,
                  its instantiation alone, 64 points equal bit for bit to a
                  direct launch of the entry points' wrapper.
 22d. hh_rkf45_evaluate  `evaluate` on params/hodgkinhuxley1_r4 with
                  solver_builder RKF45 (10^4 steps, 100 g_Na x 4): 4
                  launches of its instantiation, the last stage's argmin
                  within 10% of 25, every point equal bit for bit to a
                  direct launch (a non-finite point, as the JAX CLI's
                  float32 run has, equal too).
 22e. hh_rkf45_optimize  `optimize` on the same, 100 restarts x 4 stages,
                  lbfgs_maxiter HH_RKF45_LBFGS_MAXITER (10): its two
                  instantiations alone, >= 95% finite, every stage descends;
                  HH_RKF45_LANES float64 lanes of the same model, solver and
                  time rule over HH_RKF45_LANES_STEPS (200) steps from
                  t0 = 9 (the stimulus onset inside) against the plain
                  version on the host's CPU (1e-9, 1e-8).
 22f. team_timing  every team instantiation at B = 256: the tile models over
                  1,000 steps with a correct a step (median of 3), HH from
                  rest over 10^4 steps on reduced-4 and 2,000 on reduced-1
                  and full (TEAM_HH_TIMING_STEPS: their explicit chains turn
                  non-finite near step 2,420; median of 3; nll_bwd on the
                  experiment's optimized rows; the timed lanes' finite count
                  recorded), beside the bound (the plain version's counted
                  operations) and the plain version's host time on
                  team_parity's rig. The kernels line lists
                  them under rows 1 and 3 (HH) and rows 2 and 4 (Kvaerno3
                  on the tile models) as `instantiations`.
 23. ode_solver   the port's run_ode_solver (float64) on gt/lotkavolterra
                  (Dopri65) and noise_gt/lotkavolterra (Kvaerno3, noise of
                  variance 0.1 from a torch.Generator on the card), cut to
                  ODE_GT_STEPS and ODE_NOISE_STEPS: x and t equal the port's
                  float64 CPU run at rtol 1e-9; the noise (the card's noisy x
                  minus the CPU's noise-free one) has a sample mean and
                  variance within 5 standard errors of 0 and 0.1.
 24. filter_ekf   run_filter on ekf_trajectory/rkf45/{lotkavolterra, lorenz,
                  vanderpol, lcao} at full size (2000-8000 steps), float32
                  and float64: float64 card against the port's float64 CPU on
                  x (elementwise, rtol 1e-9) and P_sqrt (each saved step
                  relative to its largest element, 1e-9), Lorenz on its first
                  LORENZ_HELD_STEPS steps (chaotic), the rest reported;
                  float32 against float64 reported.
 25. filter_pf    run_filter on pf_trajectory/rkf45/lotkavolterra (100
                  particles, 2000 steps, float32), twice with its seed:
                  the same ensemble, every particle finite, particle 0 equal
                  to make_solve_fn on the card at rtol 1e-9; the spread
                  reported.
 26. filter_ext   run_filter on the LV ekf_trajectory config with the filter
                  node swapped (DenseEKF, UKF, SqrtUKF, GMMSqrtEKF; 2000
                  steps, float64): every output key against the float64 CPU
                  at 1e-9 (each saved step relative to its largest element);
                  reported beside it, the change that moving x0 by one ulp
                  makes on the CPU.
 27. calibration  run_calibration on calibration/rkf45/lotkavolterra at full
                  size (500 levels, 2000 steps, float32 and float64) on the
                  committed ground truth (data/gt_lotkavolterra.npz): the
                  float64 card's levels and NLLs (all 500 and nll_ours)
                  against the float64 CPU at rtol 1e-9, the argmin level
                  equal; float32 and the NLLs' one-ulp conditioning
                  reported.
                  The float64 CPU references of phases 23-28 run in a process
                  of their own (REF_THREADS threads) from the build phase on;
                  so do the plain references of phases 9 and 13 (the spike
                  rig's x0 and the plain values and gradients, in
                  PLAIN_REF_GROUPS processes of one thread each).
                  Each of these phases prints its wall and per-step seconds.
 28. c2_route     the estimation objective's route without a kernel (make_nll +
                  autograd through the Kvaerno3 stage-solve rule at second
                  order) on params/hodgkinhuxley2_c2_r4 (two compartments,
                  n = 8, V of both observed, g_Na and g_K per compartment:
                  4 rows), float64, through the entry points' batched_nll
                  on the committed npz observations. One forward plus
                  backward on 100 lanes of a C2_RIG_STEPS-step rig across the
                  stimulus onset (t0 = C2_T0, rest state): 4 points at each
                  of the 4 stages' gamma^1/2 held to the port's float64 CPU
                  run of the same lanes (the reference process): NLL rtol
                  1e-9, gradients (rows and d/d gamma^1/2) max relative
                  error 1e-8; the gradient at the 4 points (first stage)
                  held to central differences (step 1e-5 in every
                  normalized coordinate and in gamma^1/2) of the same
                  forward's neighbouring lanes (lane-normalized error
                  <= 1e-4). Reported: the seconds per step of the forward
                  (no autograd) and of forward plus backward at 1 and at 100
                  lanes, and torch.cuda.max_memory_allocated of forward
                  plus backward at 100 lanes at the horizons
                  C2_MEMORY_HORIZONS with a checkpoint per observation
                  interval (remat) and with none (chunk_size=1).
 29. c2_optimize  the port's `optimize` on params/hodgkinhuxley2_c2_r4 at full
                  width (100 restarts from seed 224, 4 stages, float32, the
                  committed npz observations), horizon cut to C2_OPT_STEPS
                  steps and lbfgs_maxiter to C2_LBFGS_MAXITER: shapes, the
                  route "make_nll + autograd", >= 95% of restarts finite, at
                  every stage the best final NLL at most the best NLL at the
                  points the stage started from (the same objective);
                  wall seconds, dispatches per stage, lanes at the iteration
                  limit and peak memory reported.
 30. device_optimize  the port's `optimize --set optimizer_mode=device` (the
                  device L-BFGS, projected Armijo, in segments) on
                  params/lotkavolterra2 at full size (100 restarts, 4 stages,
                  2000 steps, float32, lbfgs_maxiter 200) on the synthesized
                  observations, the counts set to 0 just before: shapes, both
                  kernels launched (one nll_fwd and one nll_bwd a dispatch),
                  the route and mode, >= 95% of restarts finite. Per stage:
                  wall seconds, dispatches, the widest, lanes at the
                  iteration limit, the kernels' seconds and share (CUDA events
                  around each launch). The best NLL and optimum are reported
                  beside the host optimize phase's, not held: the Armijo
                  search is another optimizer than the host's strong Wolfe.
 31. device_parity  the device stage optimizer over the entry points'
                  batched_nll on params/lotkavolterra2 cut to
                  DEVICE_PARITY_STEPS steps, float64, 8 restarts, the first
                  stage's gamma and 0: the card (kernels) against the same
                  run on the host's CPU (plain versions, the device reference
                  process): iterations and evaluations equal in every lane, x
                  within 1e-8 (normalized box), f rtol 1e-9.
 32. baseline     the filter-free baseline (make_baseline_nll, autograd through
                  the eager solve; no kernel) on params_baseline/lotkavolterra2:
                  `optimize` at full width (100 restarts, 2000 RKF45 steps,
                  float32) with lbfgs_maxiter cut to BASELINE_LBFGS_MAXITER
                  (0: the timed value-and-gradient dispatch at 100 lanes,
                  lbfgs_box's initial evaluation; >= 95% finite) and
                  `evaluate` on its 50 x 50 grid at the full horizon (one
                  batch, eval_batch BASELINE_EVAL_BATCH); float64 card
                  against the CPU: the NLL at 16 grid points (rtol 1e-9) and
                  lbfgs_box from 8 restarts on the rig cut to
                  BASELINE_PARITY_STEPS steps (as device_parity). No NLL
                  kernel may launch.
 33. trmse        the port's compute_trmse on device_optimize's output (100
                  rows, 2000 steps), float64 card against float64 CPU: the
                  non-finite rows coincide, values, mean and std at rtol
                  1e-9; both times.
                  The CPU float64 runs of phases 31, 32 and 38 come from a
                  process of their own (one thread) started with the others,
                  once the observations exist.
 34. mesh_host    the host L-BFGS's `mesh=` (parallel/mesh.py): every stage
                  of params/lotkavolterra2 at full size (100 restarts from
                  the CLI's seeded generator, 4 stages, 2000 steps, float32,
                  lbfgs_maxiter 200, the synthesized observations) through
                  make_stage_optimizer_host over the LV kernels' wrapper
                  built on each device, once on device_mesh() (every visible
                  card) and once on MESH_SHARDS (4) shards (four cards, or
                  four streams of cuda:0 on a one-card machine); each held
                  per lane, bit for bit on x, f, iterations and evaluations,
                  to the unsharded host optimizer from the same restarts.
                  Wall seconds, dispatches and the kernels' summed device
                  seconds reported beside the unsharded run's.
 35. mesh_device  make_sharded_tempered_estimator over the same wrapper on 4
                  shards, gammas 1e-2 and 0, max_iter 15: every lane's
                  iterations and evaluations equal to the unsharded
                  make_tempered_estimator's, x within 1e-8 (normalized box).
 36. mesh_landscape  make_sharded_nll_landscape on 4 shards over evaluate's
                  20 x 20 grid at its 4 gammas: bit for bit
                  make_nll_landscape's, 16 launches.
 37. measure_scaling  `python -m ode_uncertainty_tpu_torch.measure_scaling
                  --path host --devices 1,2,4 --per-device 16` on the card:
                  its lines, each finite and naming its cards.
 38. diag_nan_lanes  the committed results/params/hodgkinhuxley11_full.h5
                  (its npz copy) re-evaluated at its non-finite lanes' stage
                  entry points in float32 and float64 through the n = 8
                  nll_fwd at 10^4 steps: the classification per lane, the
                  launches and seconds; at DIAG_CUT_STEPS (20) steps the
                  float64 card against the float64 plain version on the
                  CPU (the device reference process) at rtol 1e-9 on the
                  lanes that are finite in float64.
 39. compare_optimizer  `compare_optimizer --restarts 8 --maxiter 15` on
                  params/lotkavolterra2 (float64 on the card, the
                  synthesized observations): the table; the host and device
                  rows' best NLL finite.
 40. kernels      one JSON line with the kernel list (nll_fwd with the ERK step,
                  nll_fwd with the Kvaerno3 step, nll_bwd, nll_bwd with the
                  Kvaerno3 step for n = 4, 7 and 8; launches by path; each
                  row with its `instantiations`), the
                  nvidia-smi line, then the device line. The solution paths,
                  the c2 phases and the baseline launch none of them: no TPU
                  kernel lies on them.

Phase 4 runs after phase 8, so that its float64 reference, which gets
little of the host beside the build, is ready. The Hodgkin-Huxley phases
run in the order 10, 11, 15, 16, 9, 12, 13, 14, 17: the two optimize phases first, so that the plain references that
phases 9 and 13 read (host CPU work) are ready when those run; the erk
phases 18-22 and the team phases 22a-22f after them.
The build phase reports each instantiation's registers, spills and ptxas
time. Every phase line after the first names the card and its power limit
(`card`). Files too long for the output (the ptxas report, the synthesized
observations, the results) go to chiprun_out/. Any failed check raises, and
the script exits non-zero without printing the last line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ode_uncertainty_tpu_torch import models, solvers
from ode_uncertainty_tpu_torch.filters import SqrtEKF
from ode_uncertainty_tpu_torch.inference import make_obs_model, make_param_spec
from ode_uncertainty_tpu_torch.ops import const_diag
from ode_uncertainty_tpu_torch.ops import nll_kernel
from ode_uncertainty_tpu_torch import compare_optimizer, compute_trmse, diag_nan_lanes, measure_scaling
from ode_uncertainty_tpu_torch._common import num_steps_of
from ode_uncertainty_tpu_torch import run_parameter_estimation as rpe
from ode_uncertainty_tpu_torch import run_parameter_estimation_baseline as rpeb
from ode_uncertainty_tpu_torch.inference import LBFGSResult, lbfgs_box
from ode_uncertainty_tpu_torch.inference import make_nll_landscape, make_stage_optimizer_host, make_tempered_estimator
from ode_uncertainty_tpu_torch.inference.estimate import make_stage_optimizer
from ode_uncertainty_tpu_torch.parallel import (
    device_mesh,
    make_sharded_nll_landscape,
    make_sharded_tempered_estimator,
)
from ode_uncertainty_tpu_torch.run_parameter_estimation import build_rig, evaluate, gammas_of, optimize
from ode_uncertainty_tpu_torch.utils.autograd_probe import nll_of, peak_memory, rig_at, step_times, synced
from ode_uncertainty_tpu_torch.utils.autograd_probe import points as probe_points
from ode_uncertainty_tpu_torch.utils.config import build_config, load_experiment, parse_literal
from ode_uncertainty_tpu_torch.utils.cuda_build import build_library
from ode_uncertainty_tpu_torch.utils.mesh_probe import Objective

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
DEVICE = "cuda"
SEED = 0
PARITY_LANES = 1024
GRID_CHECK = 64  # main-path grid points also evaluated by the float64 plain version
RTOL_F64 = 1e-9
P99_F32 = 2e-4
GRAD_LANES = 256
GRAD_RTOL_F64 = 1e-8
GRAD_P99_F32 = 5e-3
BENCH_GRAD_STEPS = 400  # the bench rig's horizon in grad parity (600 before the mesh phases)
PLAIN_TIMING_STEPS = 100  # the plain versions are timed at this cut horizon (200 before the team phases)
HH_EXPERIMENT = "params/hodgkinhuxley1_r4"
HH_DATA = ROOT / "ode_uncertainty_tpu_torch" / "data"
HH_RIG_STEPS = 200  # horizon of the Kvaerno3 parity rigs
# horizon of hh_parity's two HH-full rigs: their plain runs on the CPU took
# ~52 s each at 200 steps, ~25 s at 100; cut to keep the script near its
# time target
HH_FULL_RIG_STEPS = 50
HH_PARITY_LANES = 256
HH_P99_F32 = 5e-4  # the implicit value tolerance of tests/test_pallas_ekf.py:314
HH_GRID_CHECK = 8
# the Kvaerno3 plain version costs ~0.2 s a step on the card (~0.5 s at n = 8);
# its timing horizon, cut from 20 steps to 5 to make room for the mesh phases
HH_PLAIN_TIMING_STEPS = 5
# the n = 8 plain gradient's timing horizon: ~0.6 s a step on the card (16 s
# for 20 steps, three timings), cut to make room for the later phases
HH_N8_PLAIN_TIMING_STEPS = 1  # 3 before the mesh phases, 2 before the team phases
HH_GNA_TRUE = 25.0  # the generating g_Na (models/hodgkin_huxley.py _SINGLE_DEFAULTS)
HH_GRAD_LANES = 64
HH_GRAD_P99_F32 = 1e-2  # the implicit gradient rtol of tests/test_pallas_ekf.py:319
HH_FD_REL_STEP = 1e-7  # central differences in g_Na over the full horizon
HH_FD_TOL = 1e-4  # |kernel - differences| / (|differences| + 1)
# Stages where the float32 gradient is held to the float64 one over the full
# horizon. At stage 0 the lane at g_Na = 80 sits where the NLL curves
# sharply (central differences reach the float64 gradient only as the step
# shrinks to 1e-7 of g_Na) and float32 rounding moves its gradient by more
# than the limit: reported, with the float32 and float64 gradients at
# neighbouring g_Na (HH_F32_PROBE_REL apart) beside it.
HH_GRAD_F32_HELD_STAGES = (1, 2, 3)
HH_F32_PROBE_REL = 1e-6
# hh_optimize's depth: the experiment's 200 took 336 s on the card (a
# straggler ran stage 2 to 113 iterations, 245 s), 40 took 84 s; cut to 20
# to keep the script well inside its 1,200 s limit, to 12 to make room for
# the mesh phases, then 10 (at 20, 78 lanes of stage 1 reached the limit
# and the other stages' medians were 9-10 iterations). The width (100
# restarts, 4 stages, 10^4 steps, float32, the real observations) is not
# cut.
HH_LBFGS_MAXITER = 10
HH_FULL_EXPERIMENT = "params/hodgkinhuxley7_full"
# horizon of hh_grad_parity's n = 7 and n = 8 rigs (64 lanes, every row): the
# float64 plain gradient, and on the g_Na rigs the float32 one, take 20-30 s
# each on the host's CPU at this depth
HH_FULL_GRAD_RIG_STEPS = 60
# hh_full_optimize's depth: the experiment's 400 would run for hours (one
# dispatch, nll_fwd plus nll_bwd over 7 directions at up to 256 lanes, takes
# 1.17 s on the card; at 20 the phase made 273 dispatches in 321 s, at 12
# 175 in 205 s, at 10 the port's optimize took 187 s with 98 restarts
# finite; at 8, 6 and at 6, 14 of the 100 restarts ended non-finite,
# measured on one H100); cut so that the phase stays under ~200 s. The
# width (100 restarts, 4 stages, 10^4 steps, 7 rows, float32, the real
# observations) is not cut.
HH_FULL_LBFGS_MAXITER = 10
HH_FULL_TIMING_REPS = 1  # CUDA-event timings of the n = 8 gradient (about a second each; 3, then 2 before the mesh and team phases)
# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet): HBM3
# bandwidth, non-tensor float32 and float64 FLOP/s.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


CARD = None  # nvidia-smi's name and power limit, set by the device phase


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# the device code's model functors and tableaus (csrc/ekf_chain.cuh) by the port's names
PTXAS_MODELS = {"LotkaVolterra": "lotka_volterra", "Lorenz": "lorenz", "VanDerPol": "van_der_pol",
                "Pendulum": "pendulum", "Logistic": "logistic", "Exponential": "exponential",
                "HodgkinHuxley": "hodgkin_huxley"}
PTXAS_TABLEAUS = {"HeunEuler": "heun_euler", "Bs32": "bs32", "Rkf45": "rkf45", "Dopri65": "dopri65",
                  "Kvaerno3": "kvaerno3"}
TILE_N = {"lotka_volterra": 2, "lorenz": 3, "van_der_pol": 2, "pendulum": 2, "logistic": 1, "exponential": 1}


def ptxas_report(log: str) -> list:
    """Registers, spills and compile time of each kernel instantiation, from
    nvcc's -Xptxas=-v output."""
    out = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*?(nll_(?:fwd|bwd))(_team)?_kernelI([fd])(.*)'", line)
        if entry:
            kernel, team, real, rest = entry.group(1, 2, 3, 4)
            # the template's class arguments, length-prefixed in the mangled name
            names = [rest[m.end():m.end() + int(m.group(1))] for m in re.finditer(r"NS_(\d+)", rest)]
            model = next(PTXAS_MODELS[x] for x in names if x in PTXAS_MODELS)
            tableau = next(PTXAS_TABLEAUS[x] for x in names if x in PTXAS_TABLEAUS)
            if team:  # nll_*_team_kernel<real, Model, L, Tab>, Model HodgkinHuxley<n> or a tile model
                hh = re.search(r"HodgkinHuxleyILi(\d+)E", rest)
                n = int(hh.group(1)) if hh else TILE_N[model]
                obs = re.search(r"Li(\d+)E", rest[hh.end():] if hh else rest).group(1)
            else:
                n, obs = re.match(r"Li(\d+)ELi(\d+)E", rest).group(1, 2)
            out.append({"kernel": kernel, "model": model, "tableau": tableau, "n": int(n), "L": int(obs),
                        "design": "team per lane" if team else "thread per lane",
                        "dtype": "float32" if real == "f" else "float64"})
        elif out and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[-1].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif out and (m := re.search(r"Used (\d+) registers", line)):
            out[-1]["registers"] = int(m.group(1))
        elif out and (m := re.search(r"Compile time = ([\d.]+) ms", line)):
            out[-1]["ptxas_ms"] = float(m.group(1))
    return out


class Phase:
    """Times a phase and prints its JSON line on success."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            card = {} if CARD is None else {"card": CARD}
            emit({"phase": self.name, "seconds": time.perf_counter() - self.t0, **card, **self.info})
        return False


class OpCounter(TorchDispatchMode):
    """Counts the arithmetic the plain version does: one operation per
    output element of an elementwise operation (fused multiply-adds count
    as two), two per inner term of a matrix product."""

    ARITH = {"add", "sub", "rsub", "mul", "div", "sqrt", "abs", "maximum", "where",
             "clamp", "log", "neg", "gt", "ge", "lt", "le", "exp", "expm1", "pow", "reciprocal",
             "logical_and", "bitwise_and"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    PRODUCTS = {"bmm", "mm", "mv", "dot"}  # a multiply-add per inner term

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.ARITH and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        elif name in self.PRODUCTS:
            self.ops += 2 * out.numel() * args[0].shape[-1]
        return out


def ops_per_lane(cm, phys=None) -> int:
    """Operations one lane does over the whole horizon: the first interval
    (first + 1 predicts and a correct) plus n_obs - 1 intervals of d,
    counted on one lane of the plain version (at the parameter column
    ``phys`` [K, 1], or all parameters 1)."""
    like = torch.zeros(1, dtype=cm.dtype)
    if phys is None:
        params = {k: like + 1.0 for k in cm.offsets}
    else:
        params = {k: phys[row].cpu().to(cm.dtype) for k, row in cm.offsets.items()}
    qg = [[like + 0.1 * q for q in row] for row in cm.Q]
    r_const = [[like + r for r in row] for row in cm.R]
    x = [like + v for v in cm.x0]
    p_mat = [[like + v for v in row] for row in cm.p0]
    y = [like for _ in range(cm.L)]
    counts = []
    for count in (cm.first + 1, cm.d):
        # without autograd: the Kvaerno3 step re-attaches its stage solutions
        # for reverse mode only, work the forward kernel does not do
        with torch.no_grad(), OpCounter() as c:
            cm.interval(x, p_mat, params, qg, r_const, y, count, like.new_full((), cm.t0))
        counts.append(c.ops)
    return counts[0] + (cm.n_obs - 1) * counts[1]


GRAD_OPS: dict = {}  # grad_ops_per_lane's counts by chain structure


def grad_ops_per_lane(cm) -> int:
    """Operations one lane's gradient takes by reverse mode (the plain
    version's forward and backward over the whole horizon): counted on one
    lane for 2 and 3 observations, the rest by the per-interval increment.
    The count depends on the chain's structure alone (not on its type), so
    it is counted once for each structure."""
    key = (cm.model_name, cm.solver.name, cm.n, cm.L, cm.d, cm.first, cm.n_obs, cm.k_params, cm.accumulate_time)
    if key in GRAD_OPS:
        return GRAD_OPS[key]
    counts = []
    for n_obs in (2, 3):
        short = dataclasses.replace(cm, n_obs=n_obs)
        phys = torch.ones((cm.k_params, 1), dtype=cm.dtype)
        ys = torch.zeros((n_obs, cm.L), dtype=cm.dtype)
        with OpCounter() as c:
            nll_kernel.nll_grad_plain(short, phys, ys, 0.1, torch.ones(1, dtype=cm.dtype))
        counts.append(c.ops)
    GRAD_OPS[key] = counts[0] + (cm.n_obs - 2) * (counts[1] - counts[0])
    return GRAD_OPS[key]


def bound_ms(cm, batch: int, grad: bool = False, phys=None, lane_ops: int = None) -> tuple:
    """Least time for one launch: bytes in and out over HBM bandwidth vs the
    operations over the non-tensor peak of the dtype. The forward reads the
    parameter rows and the observations and writes the NLL; the gradient
    also reads the cotangent and writes the parameter rows' gradient.
    ``lane_ops``: one lane's operations, counted elsewhere."""
    item = torch.finfo(cm.dtype).bits // 8
    values = cm.k_params * batch + cm.n_obs * cm.L + batch
    if grad:
        values += cm.k_params * batch
    if lane_ops is None:
        lane_ops = grad_ops_per_lane(cm) if grad else ops_per_lane(cm, phys)
    ops = lane_ops * batch
    t_bytes = values * item / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[cm.dtype] * 1e3
    return (t_ops, "operations", ops) if t_ops >= t_bytes else (t_bytes, "bytes", ops)


def cut(cm, steps: int):
    """The chain of ``cm`` cut to its first ``steps`` steps (whole intervals),
    for timing the plain versions."""
    return dataclasses.replace(cm, n_obs=min(cm.n_obs, max(1, (steps - cm.first - 1) // cm.d + 1)))


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_times(fn, reps: int) -> list:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


class LaunchTimer:
    """CUDA events around every launch of the two kernel wrappers while it is
    entered: their device time by kernel, the launch counts untouched. The
    device time of a run's other operations (small tensor operations of
    the optimizer's bookkeeping) is not counted, so one minus the kernels'
    share of the wall time bounds the device's idle share from above."""

    def __enter__(self):
        self.events = []
        self.saved = (nll_kernel.NllFwd.launch, nll_kernel.NllGrad.launch)

        def timed(launch, name):
            def run(wrapper, *args, **kwargs):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = launch(wrapper, *args, **kwargs)
                end.record()
                self.events.append((name, start, end))
                return out
            return run

        nll_kernel.NllFwd.launch = timed(self.saved[0], "nll_fwd")
        nll_kernel.NllGrad.launch = timed(self.saved[1], "nll_bwd")
        return self

    def __exit__(self, *exc):
        nll_kernel.NllFwd.launch, nll_kernel.NllGrad.launch = self.saved
        return False

    def seconds(self) -> dict:
        torch.cuda.synchronize()
        out = {"nll_fwd": 0.0, "nll_bwd": 0.0}
        for name, start, end in self.events:
            out[name] += start.elapsed_time(end) / 1e3
        return out

    def durations(self) -> list:
        """(kernel, seconds) of every launch, in launch order."""
        torch.cuda.synchronize()
        return [(name, start.elapsed_time(end) / 1e3) for name, start, end in self.events]


def synthesize_observations(path: Path) -> dict:
    """RKF45 solve of Lotka-Volterra at its default parameters, one point per
    step over the experiment's horizon, plus N(0, 0.1) noise; written as the
    observation file schema (t [T], x [T, 1, 2])."""
    raw = load_experiment("params/lotkavolterra2")
    h = raw["solver_builder"]["init_args"]["step_size"]
    steps = int(round((raw["tN"] - raw["t0"]) / h))
    sol = solvers.solve(
        solvers.rkf45(h), models.lotka_volterra(), raw["t0"],
        torch.tensor([[1.0, 1.0]], dtype=torch.float64, device=DEVICE), steps,
    )
    x = sol["x"].cpu().numpy()
    noise = np.sqrt(raw["obs_noise_var"]) * np.random.default_rng(SEED).standard_normal(x.shape)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, t=sol["t"].cpu().numpy(), x=x + noise)
    tmp.replace(path)  # whole: the device reference process waits for it
    return {"observations": str(path.relative_to(ROOT)), "points": int(x.shape[0]), "steps": steps,
            "noise_var": raw["obs_noise_var"], "seed": SEED}


def lv2_config(obs_path: Path, out_path: Path):
    return build_config(
        load_experiment("params/lotkavolterra2"),
        {"y_path": str(obs_path), "output": str(out_path), "device": DEVICE},
    )


def bench_lv_kernel(dtype, num_steps=2000, obs_every=10, noise=0.1):
    """bench.py's `lv` rig (bench.py:51-52, 117-137) in the port."""
    m = models.lotka_volterra()
    h = 0.01
    sol = solvers.rkf45(h)
    x0 = torch.tensor([[1.0, 1.0]], dtype=dtype, device=DEVICE)
    gt = solvers.solve(sol, m, 0.0, x0, num_steps)
    idx = np.arange(obs_every, num_steps + 1, obs_every)
    ys = gt["x"].cpu().numpy()[idx].reshape(len(idx), -1)
    ys = ys + np.sqrt(noise) * np.random.default_rng(0).standard_normal(ys.shape)
    obs = make_obs_model(np.eye(2), gt["t"].cpu().numpy()[idx], ys, noise, 0.0, h, num_steps,
                         dtype=dtype, device=DEVICE)
    spec = make_param_spec(m.params, {k: (0.1, 5.0) for k in m.params},
                           {"alpha": True, "beta": True, "gamma": False, "delta": False},
                           dtype=dtype, device=DEVICE)
    ekf = SqrtEKF(disable_cov_update=True)
    state0 = ekf.init_state(0.0, x0, const_diag(2, 1e-12, dtype, DEVICE), obs.obs_dim)
    q = torch.eye(2, dtype=dtype, device=DEVICE)
    return nll_kernel.make_nll_cuda(m, sol, ekf, spec, obs, state0, num_steps, q)


def lv2_kernel(cfg, dtype):
    rig = build_rig(cfg, dtype, torch.device(DEVICE))
    return nll_kernel.make_nll_cuda(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs,
                                    rig.state0, rig.num_steps, rig.q_sqrt)


def lv2_grid(cfg) -> tuple:
    """(indices, axes, normalized points, (first, last) stage's gamma^1/2) of
    the GRID_CHECK points of evaluate's 20 x 20 grid held to the plain
    version."""
    grid_idx = np.linspace(0, 399, GRID_CHECK).astype(int)
    axes = [np.linspace(0.0, 1.0, 20)] * 2
    grid_norm = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 2)[grid_idx]
    gammas = cfg["gamma_noise_schedule"].gammas(4, True).to(torch.float32)
    return grid_idx, axes, grid_norm, (float(torch.sqrt(gammas[0])), float(torch.sqrt(gammas[-1])))


def lv_parity_rigs(cfg=None) -> dict:
    """key -> (rig name, wrapper maker, keyword arguments) of the rigs that
    parity (``parity_*``) and grad_parity (``grad_*``) hold to a plain
    version; ``cfg`` is the lotkavolterra2 config on the synthesized
    observations (None: the bench.py rigs alone)."""
    rigs = {"parity_bench": ("bench.py lv", bench_lv_kernel, {}),
            "grad_bench": (f"bench.py lv, {BENCH_GRAD_STEPS} steps",
                           lambda dt: bench_lv_kernel(dt, num_steps=BENCH_GRAD_STEPS), {})}
    if cfg is not None:
        _, _, grid_norm, grid_gammas = lv2_grid(cfg)
        lv2 = lambda dt: lv2_kernel(cfg, dt)
        rigs.update(parity_lv2=("params/lotkavolterra2", lv2, dict(grid_norm=grid_norm, grid_gammas=grid_gammas)),
                    grad_lv2=("params/lotkavolterra2", lv2, {}))
    return rigs


def compare(kernel_vals, plain_vals, exact: bool, p99_limit: float = P99_F32) -> dict:
    """Kernel values against the float64 plain version's: float64 max
    relative error <= RTOL_F64, float32 p99 of the lane-normalized error
    <= ``p99_limit`` (None: reported, not held); the lanes that are not
    finite must coincide."""
    k = kernel_vals.double().cpu().numpy()
    p = plain_vals.double().cpu().numpy()
    fin_k, fin_p = np.isfinite(k), np.isfinite(p)
    both = fin_k & fin_p
    if exact:
        err = np.abs(k[both] - p[both]) / np.abs(p[both])
        stat = {"max_rel_err": float(err.max()), "rtol": RTOL_F64}
        ok = stat["max_rel_err"] <= RTOL_F64
    else:
        err = np.abs(k[both] - p[both]) / (np.abs(p[both]) + 1.0)
        stat = {"p99_lane_err": float(np.quantile(err, 0.99)), "max_lane_err": float(err.max()),
                "p99_limit": p99_limit}
        ok = p99_limit is None or stat["p99_lane_err"] <= p99_limit
    mismatch = int((fin_k != fin_p).sum())
    stat.update(lanes=int(k.size), nonfinite_kernel=int((~fin_k).sum()),
                nonfinite_plain=int((~fin_p).sum()), nonfinite_mismatch=mismatch,
                max_abs_err=float(np.abs(k[both] - p[both]).max()))
    if not ok or mismatch:
        raise AssertionError(f"kernel disagrees with its plain version: {stat}")
    return stat


def parity_groups(cols: int, grid_norm=None, grid_gammas=None) -> list:
    """parity's lanes as (normalized params, gamma^1/2) groups: random lanes
    at gamma^1/2 = 0.1 and gamma = 0 (plus optional grid lanes)."""
    rng = np.random.default_rng(SEED)
    half = PARITY_LANES // 2 - (0 if grid_norm is None else len(grid_norm))
    groups = []
    for g_sqrt, g_grid in ((0.1, None if grid_gammas is None else grid_gammas[0]),
                           (0.0, None if grid_gammas is None else grid_gammas[1])):
        groups.append((rng.uniform(size=(half, cols)), g_sqrt))
        if grid_norm is not None:
            groups.append((grid_norm, g_grid))
    return groups


def parity_plain(make, grid_norm=None, grid_gammas=None) -> dict:
    """parity's float64 plain version on the host's CPU (the device
    reference process)."""
    k64 = make(torch.float64)
    groups = parity_groups(k64.spec.num_opt, grid_norm, grid_gammas)
    p_all = torch.as_tensor(np.concatenate([g[0] for g in groups]))
    g_all = torch.as_tensor(np.concatenate([np.full(len(g[0]), g[1]) for g in groups]), dtype=torch.float64)
    phys64 = k64.physical(p_all.to(DEVICE)).cpu()
    plain64, ms = cpu_time(lambda: nll_kernel.nll_plain(k64.cm, phys64, k64.ys.cpu(), g_all))
    return {"plain64": plain64, "ms": ms}


def parity(name, make, ref: dict, grid_norm=None, grid_gammas=None) -> dict:
    """Kernel (float64 and float32) against the float64 plain version
    (``ref``, from :func:`parity_plain`) on parity_groups' lanes."""
    k64, k32 = make(torch.float64), make(torch.float32)
    groups = parity_groups(k64.spec.num_opt, grid_norm, grid_gammas)
    plain64 = ref["plain64"]
    out = {"rig": name, "L": k64.cm.L, "d": k64.cm.d, "n_obs": k64.cm.n_obs,
           "plain_f64_cpu_ms": ref["ms"], "plain_waited_s": ref["waited_s"]}
    for label, kern, exact in (("f64", k64, True), ("f32", k32, False)):
        vals = torch.cat([kern.launch(kern.physical(torch.as_tensor(p, device=DEVICE)), g)
                          for p, g in groups])
        torch.cuda.synchronize()
        out[f"kernel_{label}_vs_plain_f64"] = compare(vals, plain64, exact)
    out["_plain64"] = plain64
    return out


def compare_grads(kernel_vals, plain_vals, exact: bool, p99_limit: float = GRAD_P99_F32,
                  diverged_lanes: bool = False) -> dict:
    """[K + 1, B] gradients (parameter rows, then each lane's d/d gamma^1/2)
    of the kernel against the float64 plain version; a float32 ``p99_limit``
    of None reports the error (on the lanes finite on both sides) without
    holding it. Else no value may be non-finite, or with ``diverged_lanes``
    only whole lanes on both sides alike (a lane whose NLL itself
    diverges), the rest compared."""
    k = kernel_vals.double().cpu().numpy()
    p = plain_vals.double().cpu().numpy()
    stat = {"values": int(k.size), "nonfinite_kernel": int((~np.isfinite(k)).sum()),
            "nonfinite_plain": int((~np.isfinite(p)).sum())}
    bad_lanes = ~np.isfinite(p).all(axis=0)
    reported = not exact and p99_limit is None
    if reported or (diverged_lanes and np.array_equal(~np.isfinite(k), np.broadcast_to(bad_lanes, k.shape))
                    and np.array_equal(~np.isfinite(p), np.broadcast_to(bad_lanes, p.shape))):
        keep = np.isfinite(k).all(axis=0) & ~bad_lanes
        stat["nonfinite_lanes"] = np.nonzero(~keep)[0].tolist()
        k, p = k[:, keep], p[:, keep]
    elif stat["nonfinite_kernel"] or stat["nonfinite_plain"]:
        raise AssertionError(f"non-finite gradients: {stat}")
    diff = np.abs(k - p)
    stat["max_abs_err"] = float(diff.max())
    if exact:
        rel = diff / np.where(p != 0, np.abs(p), np.abs(p).max())
        stat.update(max_rel_err=float(rel.max()), rtol=GRAD_RTOL_F64)
        ok = stat["max_rel_err"] <= GRAD_RTOL_F64
    else:
        err = diff / (np.abs(p) + 1.0)
        stat.update(p99_lane_err=float(np.quantile(err, 0.99)), max_lane_err=float(err.max()),
                    p99_limit=p99_limit)
        ok = p99_limit is None or stat["p99_lane_err"] <= p99_limit
    if not ok:
        raise AssertionError(f"nll_bwd disagrees with its plain version: {stat}")
    return stat


def grad_inputs(cols: int) -> tuple:
    """grad_parity's GRAD_LANES random lanes, half at gamma^1/2 = 0.1 and
    half at 0, with a random cotangent: (points, cotangents, gamma^1/2) on
    DEVICE."""
    rng = np.random.default_rng(SEED + 1)
    p = torch.as_tensor(rng.uniform(size=(GRAD_LANES, cols)), device=DEVICE)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, size=GRAD_LANES), device=DEVICE)
    gs = torch.as_tensor(np.repeat([0.1, 0.0], GRAD_LANES // 2), device=DEVICE)
    return p, g, gs


def grad_plain(make) -> dict:
    """grad_parity's float64 plain gradient on the host's CPU (the device
    reference process): [K + 1, B] (rows, then d/d gamma^1/2)."""
    k64 = make(torch.float64)
    p, g, gs = grad_inputs(k64.spec.num_opt)
    (dphys, dgamma), ms = cpu_time(lambda: nll_kernel.nll_grad_plain(
        k64.cm, k64.physical(p).cpu(), k64.ys.cpu(), gs.cpu(), g.cpu()))
    return {"plain64": torch.cat([dphys, dgamma[None]]), "ms": ms}


def grad_parity(name, make, ref: dict) -> dict:
    """nll_bwd (float64 and float32) against the float64 plain gradient
    (``ref``, from :func:`grad_plain`) on grad_inputs' lanes."""
    k64, k32 = make(torch.float64), make(torch.float32)
    half = GRAD_LANES // 2
    p, g, _ = grad_inputs(k64.spec.num_opt)
    plain = ref["plain64"]
    out = {"rig": name, "L": k64.cm.L, "d": k64.cm.d, "n_obs": k64.cm.n_obs, "lanes": GRAD_LANES,
           "plain_f64_cpu_ms": ref["ms"], "plain_waited_s": ref["waited_s"]}
    for label, kern, exact in (("f64", k64, True), ("f32", k32, False)):
        parts = [kern.grad.launch(kern.physical(p[sl]), gsv, g[sl])
                 for sl, gsv in ((slice(0, half), 0.1), (slice(half, None), 0.0))]
        got = torch.cat([torch.cat([dp, dg[None]]) for dp, dg in parts], dim=1)
        torch.cuda.synchronize()
        out[f"kernel_{label}_vs_plain_f64"] = compare_grads(got, plain, exact)
    return out


def hh_config(experiment: str = HH_EXPERIMENT, data: str = "hodgkinhuxley_r4.npz", out_path: Path = None):
    """An HH experiment's config reading the committed npz copy of its
    observation file (the card machine has no h5py)."""
    overrides = {"y_path": str(HH_DATA / data), "device": DEVICE}
    if out_path is not None:
        overrides["output"] = str(out_path)
    return build_config(load_experiment(experiment), overrides)


def hh_kernel(cfg, dtype, t0: float, steps: int, x0=None, data: str = "hodgkinhuxley_r4.npz",
              spec=None, optimized=None, accumulate_time: bool = False, device: str = None):
    """The nll_fwd wrapper of an HH experiment's model, Kvaerno3 solver and
    filter on a rig of ``steps`` steps from ``t0`` (at the rest state
    unless ``x0`` [1, n] is given), V observed after every step: the
    committed observation rows at those times. The parameters varied are
    the experiment's, or ``optimized`` (names), or those of ``spec``."""
    model, solver, ekf = cfg["ode_builder"], cfg["solver_builder"], cfg["filter_builder"]
    n, h = model.state_size, solver.h
    device = DEVICE if device is None else device
    if x0 is None:
        x0 = model.build_initial_value(torch.tensor([[-70.0]], dtype=torch.float64), model.params)
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    obs_file = np.load(HH_DATA / data)
    i0 = int(round(t0 / h))
    rows = slice(i0 + 1, i0 + steps + 1)
    obs = make_obs_model(np.asarray(parse_literal(cfg["measurement_matrix"]), float),
                         obs_file["t"][rows], obs_file["x"][rows].reshape(steps, -1),
                         cfg["obs_noise_var"], t0, h, steps, dtype=dtype, device=device)
    if spec is None:
        opt = cfg["params_optimized"] if optimized is None else {k: k in optimized for k in model.params}
        spec = make_param_spec(model.params, cfg["params_range"], opt, dtype=dtype, device=device)
    state0 = ekf.init_state(t0, x0, const_diag(n, 1e-12, dtype, device), obs.obs_dim)
    q = torch.eye(n, dtype=dtype, device=device)
    return nll_kernel.make_nll_cuda(model, solver, ekf, spec, obs, state0, steps, q,
                                    accumulate_time=accumulate_time)


def hh_spike_state(cfg) -> torch.Tensor:
    """The float64 Kvaerno3 solve (the port's solver) of the experiment's
    model from the rest state at t = 0 to t = 23.5, just before the first
    spike: the spike rig's x0."""
    model, solver = cfg["ode_builder"], cfg["solver_builder"]
    x_rest = model.build_initial_value(torch.tensor([[-70.0]], dtype=torch.float64), model.params)
    sol = solvers.solve(solver, model, 0.0, x_rest, int(round(23.5 / solver.h)))
    return sol["x"][-1]


def cpu_time(fn):
    """(fn(), its wall milliseconds) of host work."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def hh_parity_inputs(make, gamma_sqrt, lanes=HH_PARITY_LANES):
    """hh_parity's wrappers (float64, float32), points and gamma^1/2 per lane."""
    rng = np.random.default_rng(SEED + 2)
    k64, k32 = make(torch.float64), make(torch.float32)
    p = torch.as_tensor(rng.uniform(size=(lanes, k64.spec.num_opt)), device=DEVICE)
    g_all = torch.as_tensor(np.repeat([gamma_sqrt, 0.0], lanes // 2), device=DEVICE)
    return k64, k32, p, g_all


def hh_parity_plain(make, gamma_sqrt, lanes=HH_PARITY_LANES, **_) -> dict:
    """hh_parity's float64 plain version on the host's CPU (three times
    faster than on the card, where every one of its small operations is a
    launch)."""
    k64, _, p, g_all = hh_parity_inputs(make, gamma_sqrt, lanes)
    phys64 = k64.physical(p).cpu()
    plain64, ms = cpu_time(lambda: nll_kernel.nll_plain(k64.cm, phys64, k64.ys.cpu(), g_all.cpu()))
    return {"plain64": plain64, "ms": ms}


def hh_parity(name, make, gamma_sqrt, ref: dict, f32_limit=HH_P99_F32, lanes=HH_PARITY_LANES) -> dict:
    """Kvaerno3 kernel (float64 and float32) against the float64 plain
    version (``ref``, from :func:`hh_parity_plain`) on ``lanes`` random
    lanes, half at ``gamma_sqrt`` and half at gamma = 0: float64 rtol 1e-9,
    float32 p99 of the lane-normalized error <= ``f32_limit`` (None:
    reported only)."""
    k64, k32, p, _ = hh_parity_inputs(make, gamma_sqrt, lanes)
    half = lanes // 2
    out = {"rig": name, "n": k64.cm.n, "t0": k64.cm.t0, "steps": k64.cm.n_obs, "lanes": lanes,
           "gamma_sqrt": gamma_sqrt, "plain_f64_cpu_ms": ref["ms"]}
    for label, kern, exact in (("f64", k64, True), ("f32", k32, False)):
        vals = torch.cat([kern.launch(kern.physical(p[sl]), g)
                          for sl, g in ((slice(0, half), gamma_sqrt), (slice(half, None), 0.0))])
        torch.cuda.synchronize()
        out[f"kernel_{label}_vs_plain_f64"] = compare(vals, ref["plain64"], exact, f32_limit)
    return out


def hh_grad_inputs(make, gamma_sqrt, lanes=HH_GRAD_LANES):
    """hh_grad_parity's wrappers (float64, float32), points, cotangents and
    gamma^1/2 per lane."""
    rng = np.random.default_rng(SEED + 3)
    k64, k32 = make(torch.float64), make(torch.float32)
    p = torch.as_tensor(rng.uniform(size=(lanes, k64.spec.num_opt)), device=DEVICE)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, size=lanes), device=DEVICE)
    gs = torch.as_tensor(np.repeat([gamma_sqrt, 0.0], lanes // 2), device=DEVICE)
    return k64, k32, p, g, gs


def hh_grad_plain(make, gamma_sqrt, lanes=HH_GRAD_LANES, f32_plain: bool = False, **_) -> dict:
    """hh_grad_parity's float64 plain gradient on the host's CPU, and with
    ``f32_plain`` the float32 one: [K + 1, B] each (rows, then d/d gamma^1/2)."""
    k64, k32, p, g, gs = hh_grad_inputs(make, gamma_sqrt, lanes)
    (dphys, dgamma), ms = cpu_time(
        lambda: nll_kernel.nll_grad_plain(k64.cm, k64.physical(p).cpu(), k64.ys.cpu(), gs.cpu(), g.cpu()))
    out = {"plain64": torch.cat([dphys, dgamma[None]]), "ms": ms}
    if f32_plain:
        (d32, dg32), ms32 = cpu_time(lambda: nll_kernel.nll_grad_plain(
            k32.cm, k32.physical(p).cpu(), k32.ys.cpu(), gs.float().cpu(), g.float().cpu()))
        out.update(plain32=torch.cat([d32, dg32[None]]), ms32=ms32)
    return out


def hh_grad_parity(name, make, gamma_sqrt, ref: dict, lanes=HH_GRAD_LANES, f32_limit=HH_GRAD_P99_F32,
                   f32_optimized_rows: bool = False, f32_plain: bool = False,
                   diverged_lanes: bool = False) -> dict:
    """Kvaerno3 nll_bwd (float64 and float32) against the float64 plain
    gradient (``ref``, from :func:`hh_grad_plain` on the host's CPU),
    every parameter row and each lane's
    d/d gamma^1/2, ``lanes`` random lanes half at ``gamma_sqrt`` and half at
    0 with a random cotangent (float32 p99 <= ``f32_limit``, None: reported);
    then a float32 launch over the optimized rows alone against the launch
    over every row. ``diverged_lanes``: lanes whose NLL diverges in the
    float64 plain version may be non-finite, alike in the kernel.

    ``f32_optimized_rows``: the float32 kernel is held to the float64
    plain gradient on the optimized rows and d/d gamma^1/2 (the directions
    optimize asks for), every row reported. ``f32_plain``: beside it the
    float32 plain gradient (host CPU) on every row, its own distance to the
    float64 one reported and the float32 kernel held to it at
    ``f32_limit`` (None: reported). On the n = 7 / n = 8 rigs float32
    arithmetic itself reaches the limit on rows those rigs do not vary:
    the float32 plain version's distance to the float64 one is of the
    float32 kernel's size there."""
    k64, k32, p, g, gs = hh_grad_inputs(make, gamma_sqrt, lanes)
    half = lanes // 2
    plain, plain_ms = ref["plain64"], ref["ms"]
    out = {"rig": name, "n": k64.cm.n, "t0": k64.cm.t0, "steps": k64.cm.n_obs, "lanes": lanes,
           "directions": k64.cm.k_params + 1, "gamma_sqrt": gamma_sqrt, "plain_f64_cpu_ms": plain_ms}
    halves = ((slice(0, half), gamma_sqrt), (slice(half, None), 0.0))
    for label, kern, exact in (("f64", k64, True), ("f32", k32, False)):
        parts = [kern.grad.launch(kern.physical(p[sl]), gsv, g[sl].to(kern.cm.dtype)) for sl, gsv in halves]
        got = torch.cat([torch.cat([dp, dg[None]]) for dp, dg in parts], dim=1)
        torch.cuda.synchronize()
        if exact or not f32_optimized_rows:
            out[f"kernel_{label}_vs_plain_f64"] = compare_grads(got, plain, exact, f32_limit, diverged_lanes)
        else:
            held = list(k32.opt_rows) + [k32.cm.k_params]
            out["kernel_f32_vs_plain_f64"] = dict(compare_grads(got[held], plain[held], False, f32_limit),
                                                  rows=held)
            out["kernel_f32_vs_plain_f64_all_rows_reported"] = compare_grads(got, plain, False, None)
        if not exact and f32_plain:
            plain32, plain32_ms = ref["plain32"], ref["ms32"]
            out["plain_f32_vs_plain_f64_all_rows_reported"] = compare_grads(plain32, plain, False, None)
            out["kernel_f32_vs_plain_f32_all_rows"] = compare_grads(got, plain32, False, f32_limit)
            out["plain_f32_cpu_ms"] = plain32_ms
        if label == "f32":
            rows = list(k32.opt_rows)
            part, _ = k32.grad.launch(k32.physical(p[:half]), gamma_sqrt, g[:half].float(), False, k32.opt_rows)
            torch.cuda.synchronize()
            others = [r for r in range(k32.cm.k_params) if r not in rows]
            if not torch.equal(part[rows], parts[0][0][rows]) or part[others].any():
                raise AssertionError("nll_bwd over the optimized rows disagrees with the launch over every row")
            out["optimized_rows_launch"] = {"rows": rows, "equal_to_all_rows_launch": True}
    return out


# The plain references of hh_parity and hh_grad_parity (~350 s of host work
# at these rigs' depths on the card machine) and of parity and grad_parity
# (the LV rigs; ~90 s eagerly on the card, ~65 s on one CPU thread) run in
# PLAIN_REF_GROUPS processes of their own from the build phase on, so that
# the card phases do not wait for them; each group is a process of one
# thread. The LV groups come first; the HH phases that read the HH groups
# run after hh_optimize and hh_full_optimize.
PLAIN_REF_DIR = OUT / "plain_refs"
LV_REF_KEYS = ("parity_lv2", "parity_bench", "grad_lv2", "grad_bench")
PLAIN_REF_GROUPS = (
    ("parity_bench", "grad_bench"),
    ("parity_lv2",),
    ("grad_lv2",),  # a process of its own: 45 s of one core, read by grad_parity right after the build
    ("spike_x0", "parity_onset_r4", "parity_onset_full", "parity_box_full", "parity_spike_r4"),
    ("grad_onset_r4", "grad_spike_r4", "grad_onset_r1"),
    ("grad_onset_full", "grad_box_full"),
)


def hh_parity_rigs(x_spike=None) -> dict:
    """key -> (rig name, wrapper maker, keyword arguments) of every rig that
    hh_parity (``parity_*``) and hh_grad_parity (``grad_*``) hold to a plain
    version; ``x_spike`` is the spike rigs' x0 (:func:`hh_spike_state`)."""
    hh_cfg, hh_r1_cfg = hh_config(), hh_config("params/hodgkinhuxley6_r1", "hodgkinhuxley_r1.npz")
    hh_full_cfg = hh_config(HH_FULL_EXPERIMENT, "hodgkinhuxley_full.npz")
    full = dict(data="hodgkinhuxley_full.npz")
    onset = lambda dt: hh_kernel(hh_cfg, dt, 9.9, HH_RIG_STEPS)
    spike = lambda dt: hh_kernel(hh_cfg, dt, 23.5, HH_RIG_STEPS, x0=x_spike)
    # the n = 7 and n = 8 units on onset rigs cut to HH_FULL_GRAD_RIG_STEPS
    grad_full = dict(f32_optimized_rows=True, f32_plain=True)
    return {
        "parity_onset_r4": ("hodgkinhuxley1_r4 onset, t0 = 9.9, rest state", onset, {}),
        "parity_onset_full": ("HH full onset, t0 = 9.9, rest state, g_Na varied",
                              lambda dt: hh_kernel(hh_full_cfg, dt, 9.9, HH_FULL_RIG_STEPS, optimized=("g_Na",),
                                                   **full), {}),
        # hodgkinhuxley7_full's seven-parameter box: the float32 plain
        # version itself is ~4e-3 (p99) off the float64 one there, so float32
        # is reported, not held; float64 is held at 1e-9 (64 lanes: an extra
        # rig, kept short in the script's time)
        "parity_box_full": ("HH full onset, t0 = 9.9, hodgkinhuxley7_full's 7 parameters varied",
                            lambda dt: hh_kernel(hh_full_cfg, dt, 9.9, HH_FULL_RIG_STEPS, **full),
                            dict(f32_limit=None, lanes=64)),
        "parity_spike_r4": ("hodgkinhuxley1_r4 spike, t0 = 23.5", spike, {}),
        "grad_onset_r4": ("hodgkinhuxley1_r4 onset, t0 = 9.9, rest state", onset, {}),
        "grad_spike_r4": ("hodgkinhuxley1_r4 spike, t0 = 23.5", spike, {}),
        "grad_onset_r1": ("hodgkinhuxley6_r1's model onset, t0 = 9.9, rest state, g_Na varied",
                          lambda dt: hh_kernel(hh_r1_cfg, dt, 9.9, HH_FULL_GRAD_RIG_STEPS, data="hodgkinhuxley_r1.npz",
                                               optimized=("g_Na",)), grad_full),
        "grad_onset_full": ("HH full onset, t0 = 9.9, rest state, g_Na varied",
                            lambda dt: hh_kernel(hh_full_cfg, dt, 9.9, HH_FULL_GRAD_RIG_STEPS, optimized=("g_Na",),
                                                 **full), grad_full),
        # hodgkinhuxley7_full's seven-parameter box: float32 reported, float64
        # held (the float32 plain version is itself off there, see hh_parity);
        # a lane at the box's edge (V_T near -86, gamma = 0) diverges within
        # the rig's steps, its NLL and gradient non-finite on both sides
        "grad_box_full": ("HH full onset, t0 = 9.9, hodgkinhuxley7_full's 7 parameters varied",
                          lambda dt: hh_kernel(hh_full_cfg, dt, 9.9, HH_FULL_GRAD_RIG_STEPS, **full),
                          dict(f32_limit=None, f32_plain=True, diverged_lanes=True)),
    }


def save_atomically(obj, path: Path) -> None:
    tmp = path.with_suffix(".tmp")
    torch.save(obj, tmp)
    tmp.replace(path)


def plain_references(out_dir: Path, keys: list) -> None:
    """Computes the plain references ``keys`` on the host's CPU, each saved
    as ``<key>.pt`` in ``out_dir``; ``spike_x0`` is the spike rigs' x0
    (the other groups wait for its file), the LV2 rigs wait for the
    synthesized observations."""
    global DEVICE
    DEVICE = "cpu"
    torch.set_num_threads(1)
    hh_gs0 = float(torch.sqrt(gammas_of(hh_config(), torch.float64)[0]))
    x_spike = None
    for key in keys:
        if key.startswith(("erk-", "erkfull-")) or key == "pendulum_lanes":
            save_atomically(erk_plain_reference(key), out_dir / f"{key}.pt")
            continue
        if key.startswith("team-") or key in TEAM_LANES:
            save_atomically(team_plain_reference(key), out_dir / f"{key}.pt")
            continue
        if key in LV_REF_KEYS:
            cfg = None
            if key.endswith("lv2"):
                while not LV2_OBS.exists():
                    time.sleep(0.5)
                cfg = lv2_config(LV2_OBS, OUT / "lv2_evaluate.npz")
            _, make, kw = lv_parity_rigs(cfg)[key]
            plain = parity_plain if key.startswith("parity") else grad_plain
            save_atomically(plain(make, **kw), out_dir / f"{key}.pt")
            continue
        if key == "spike_x0":
            x, ms = cpu_time(lambda: hh_spike_state(hh_config()))
            save_atomically({"x": x, "ms": ms}, out_dir / "spike_x0.pt")
            continue
        if "spike" in key and x_spike is None:
            while not (out_dir / "spike_x0.pt").exists():
                time.sleep(0.5)
            x_spike = torch.load(out_dir / "spike_x0.pt")["x"]
        _, make, kw = hh_parity_rigs(x_spike)[key]
        plain = hh_parity_plain if key.startswith("parity") else hh_grad_plain
        save_atomically(plain(make, hh_gs0, **kw), out_dir / f"{key}.pt")


def start_plain_references(before_build: bool) -> dict:
    """Starts the processes of the groups of PLAIN_REF_GROUPS that need no
    kernel and start before the build (``before_build``: the LV and the erk
    groups, whose host work then overlaps nvcc's rather than the reference
    processes started after it) or of the HH groups: {group index:
    process}."""
    PLAIN_REF_DIR.mkdir(exist_ok=True)
    procs = {}
    for i, keys in enumerate(PLAIN_REF_GROUPS):
        if (set(keys) <= set(LV_REF_KEYS) or set(keys) <= set(erk_ref_keys())) != before_build:
            continue
        for key in keys:
            (PLAIN_REF_DIR / f"{key}.pt").unlink(missing_ok=True)
        log = open(OUT / f"plain_references_{i}.log", "w")
        procs[i] = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--plain-references",
                                     str(PLAIN_REF_DIR), *keys], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
    return procs


def plain_ref(procs: dict, key: str) -> dict:
    """The plain reference ``key``, waiting for the process of its group."""
    path = PLAIN_REF_DIR / f"{key}.pt"
    group = next(i for i, keys in enumerate(PLAIN_REF_GROUPS) if key in keys)
    waited = time.perf_counter()
    while not path.exists():
        if procs[group].poll() is not None and not path.exists():
            raise AssertionError(f"the plain reference process {group} ended without {key}: "
                                 + (OUT / f"plain_references_{group}.log").read_text()[-4000:])
        time.sleep(0.5)
    return {**torch.load(path), "waited_s": time.perf_counter() - waited}


def hh_bench_kernel(dtype):
    """bench.py's `hh_full` rig (bench.py:61, 87-110) in the port, on the
    committed hodgkinhuxley_full observations (bench.py synthesizes its
    own; the kernel's time does not depend on them): HH full, Kvaerno3 at
    h = 0.01, 10^4 steps, V observed every step, 11 parameters optimized."""
    cfg = hh_config("params/hodgkinhuxley7_full", "hodgkinhuxley_full.npz")
    model = cfg["ode_builder"]  # HH full at its defaults, as bench.py's
    opt = {k: k in ("g_Na", "E_Na", "g_K", "E_K", "g_leak", "E_leak", "V_T", "g_M", "g_L", "E_Ca", "g_T")
           for k in model.params}
    spec = make_param_spec(model.params, cfg["params_range"], opt, dtype=dtype, device=DEVICE)
    return hh_kernel(cfg, dtype, 0.0, 10000, data="hodgkinhuxley_full.npz", spec=spec)


# ---- the explicit-step kernels on every tile model and tableau (rows 1 and 3) ----
# model -> (factory, x0 [N, D]) of the erk_parity and timing rigs (the
# experiments' x0 where the repo has one, configs/experiments.py SYSTEMS)
ERK_MODELS = {
    "lotka_volterra": (models.lotka_volterra, [[1.0, 1.0]]),
    "lorenz": (models.lorenz, [[1.0, 1.0, 1.0]]),
    "van_der_pol": (models.van_der_pol, [[2.0], [10.0]]),
    "pendulum": (models.pendulum, [[0.785398], [0.0]]),
    "logistic": (models.logistic, [[0.1]]),
    "exponential": (models.exponential, [[1.0]]),
}
ERK_TABLEAUS = ("heun_euler", "bs32", "rkf45", "dopri65")
ERK_CLASSES = {"heun_euler": "HeunEuler", "bs32": "BS32", "rkf45": "RKF45", "dopri65": "Dopri65"}
ERK_PARITY_STEPS, ERK_PARITY_EVERY = 50, 2  # erk_parity's cut horizon and observation spacing
ERK_BATCHES = (1, 33, 256)  # ragged: the last warp part empty
ERK_GAMMAS = (0.1, 0.0)
ERK_TIMING_STEPS, ERK_TIMING_BATCH, ERK_TIMING_REPS = 1000, 256, 3  # params/pendulum's horizon, a correct a step
ERK_PLAIN_TIMING_STEPS = 2
PENDULUM_EXPERIMENT = "params/pendulum"
PENDULUM_LENGTH_TRUE = 3.0  # the model default that generated results/noise_gt/pendulum.h5
PENDULUM_LANES = 4  # float64 lanes of pendulum_optimize's rig held to the plain version
# the covariance-free filter: every kernel-route experiment's, the kernels' configuration
NO_COV_FILTER = {"class_path": "SQRT_EKF", "init_args": {"disable_cov_update": True}}
# erk_full_horizon: model -> (npz copy of its results/noise_gt trace, t0, tN), h = 0.01
ERK_FULL = {"lorenz": ("lorenz.npz", 0.0, 50.0), "van_der_pol": ("vanderpol.npz", 10.0, 80.0)}
ERK_FULL_LANES = 16
ERK_FULL_PREFIX_STEPS = 50  # Lorenz is chaotic: the plain version holds the kernel on this prefix
ERK_REF_GROUPS = 3  # processes of the erk plain references


def erk_chains() -> list:
    """(model, tableau, L) of the explicit-step instantiations on a thread
    per lane: every tableau on every tile model at every L in 1..n, but
    Lotka-Volterra's RKF45 (row 1's own, in nll_fwd.cu / nll_bwd.cu)."""
    return [(m, tab, L) for m, (_, x0) in ERK_MODELS.items() for tab in ERK_TABLEAUS
            if (m, tab) != ("lotka_volterra", "rkf45") for L in range(1, int(np.size(x0)) + 1)]


@functools.cache
def synthesized_trace(model: str, steps: int) -> tuple:
    """(t, x + noise) of a float64 RKF45 solve of ``model`` at its defaults
    from ERK_MODELS' x0 at t = 0 over ``steps`` steps of 0.01, plus N(0, 0.1)
    from numpy's default_rng(SEED): the same in every process."""
    factory, x0 = ERK_MODELS[model]
    x0 = torch.tensor(x0, dtype=torch.float64)
    sol = solvers.solve(solvers.rkf45(0.01), factory(), 0.0, x0, steps)
    xs = sol["x"].numpy().reshape(steps + 1, x0.numel())
    return sol["t"].numpy(), xs + np.sqrt(0.1) * np.random.default_rng(SEED).standard_normal(xs.shape)


def erk_kernel(model: str, tableau: str, L: int, dtype, steps: int, every: int, device=None, trace=None,
               t0: float = 0.0):
    """The kernels' wrapper of ``model`` under ``tableau`` at h = 0.01 from
    ERK_MODELS' x0, every parameter varied over 0.5 to 1.5 times its
    default, the first L states observed every ``every`` steps with noise
    variance 0.1: the rows of ``trace`` (a committed npz, from ``t0``) or
    synthesized_trace's."""
    device = DEVICE if device is None else device
    factory, x0 = ERK_MODELS[model]
    m, h = factory(), 0.01
    x0 = torch.tensor(x0, dtype=torch.float64)
    n = x0.numel()
    if trace is None:
        ts, xs = synthesized_trace(model, steps)
    else:
        ts, xs = trace["t"], trace["x"].reshape(len(trace["t"]), n)
    rows = slice(every, steps + 1, every) if trace is None else slice(0, None)
    obs = make_obs_model(np.eye(n)[:L], ts[rows], xs[rows], 0.1, t0, h, steps, dtype=dtype, device=device)
    spec = make_param_spec(m.params, {k: (0.5 * float(v), 1.5 * float(v)) for k, v in m.params.items()},
                           {k: True for k in m.params}, dtype=dtype, device=device)
    ekf = SqrtEKF(disable_cov_update=True)
    state0 = ekf.init_state(t0, x0.to(device=device, dtype=dtype), const_diag(n, 1e-6, dtype, device), obs.obs_dim)
    return nll_kernel.make_nll_cuda(m, getattr(solvers, tableau)(h), ekf, spec, obs, state0, steps,
                                    torch.eye(n, dtype=dtype, device=device))


def erk_full_kernel(model: str, tableau: str, L: int, dtype, steps: int = None, device=None):
    """erk_kernel on the committed trace of ``model`` (ERK_FULL) from its t0,
    at the full horizon or its first ``steps`` steps."""
    name, t0, t_end = ERK_FULL[model]
    trace = dict(np.load(HH_DATA / name))
    full = int(round((t_end - t0) / 0.01))
    return erk_kernel(model, tableau, L, dtype, full if steps is None else steps, 1, device, trace, t0)


def erk_parity_inputs(cols: int) -> tuple:
    """erk_parity's lanes: [(points, gamma^1/2)] for each batch of
    ERK_BATCHES at each of ERK_GAMMAS, and one cotangent a lane (numpy)."""
    rng = np.random.default_rng(SEED + 4)
    groups = [(rng.uniform(size=(b, cols)), gs) for b in ERK_BATCHES for gs in ERK_GAMMAS]
    return groups, rng.uniform(0.5, 1.5, size=sum(len(p) for p, _ in groups))


def erk_full_inputs(cols: int) -> tuple:
    """erk_full_horizon's lanes: 0.9 to 1.1 times the defaults, half at
    gamma^1/2 = 0.1 and half at 0."""
    p = np.random.default_rng(SEED + 5).uniform(0.4, 0.6, size=(ERK_FULL_LANES, cols))
    return p, np.repeat([0.1, 0.0], ERK_FULL_LANES // 2)


def pendulum_config(out_path: Path, tableau: str = "rkf45", float64: bool = False, device: str = None):
    """params/pendulum with the covariance-free filter under ``tableau``, on
    the npz copy of its committed observations."""
    raw = load_experiment(PENDULUM_EXPERIMENT)
    raw["solver_builder"]["class_path"] = f"ode_uncertainty_tpu.solvers.{ERK_CLASSES[tableau]}"
    return build_config(raw, {"filter_builder": NO_COV_FILTER, "y_path": str(HH_DATA / "pendulum.npz"),
                              "output": str(out_path), "device": DEVICE if device is None else device,
                              "float64": float64})


def pendulum_lanes(device: str = None) -> tuple:
    """pendulum_optimize's float64 check: the entry points' wrapper on the
    experiment's rig, PENDULUM_LANES points, and their gamma^1/2: the first
    stage's for the first half, the last stage's for the rest."""
    cfg = pendulum_config(OUT / "unused.npz", float64=True, device=device)
    kern = rpe.batched_nll(build_rig(cfg, torch.float64, torch.device(cfg["device"])), cfg, grad=True)[0]
    p = np.random.default_rng(SEED + 6).uniform(size=(PENDULUM_LANES, 1))
    gammas = gammas_of(cfg, torch.float64)
    half = PENDULUM_LANES // 2
    return kern, p, np.repeat([float(torch.sqrt(gammas[0])), float(torch.sqrt(gammas[-1]))], [half, half])


def erk_key(prefix: str, model: str, tableau: str, L: int) -> str:
    return f"{prefix}-{model}-{tableau}-{L}"


def erk_ref_keys() -> list:
    """The plain references of the erk phases: erk_parity's (``erk-*``,
    with the timing rigs' operation counts), erk_full_horizon's prefixes
    (``erkfull-*``) and pendulum_optimize's lanes."""
    keys = [erk_key("erk", *c) for c in erk_chains()]
    keys += [erk_key("erkfull", m, tab, L) for m, n in (("lorenz", 3), ("van_der_pol", 2))
             for tab in ERK_TABLEAUS for L in (1, n)]
    return keys + ["pendulum_lanes"]


def erk_plain_reference(key: str) -> dict:
    """One erk plain reference on the host's CPU, float64."""
    if key == "pendulum_lanes":
        kern, p, gs = pendulum_lanes("cpu")
        phys, gs = kern.physical(torch.as_tensor(p)), torch.as_tensor(gs)
        (vals, (dphys, dgamma)), ms = cpu_time(lambda: (
            nll_kernel.nll_plain(kern.cm, phys, kern.ys, gs),
            nll_kernel.nll_grad_plain(kern.cm, phys, kern.ys, gs, torch.ones(len(p), dtype=torch.float64))))
        return {"plain64": vals, "grad64": torch.cat([dphys, dgamma[None]]), "ms": ms}
    prefix, model, tab, L = key.split("-")
    L = int(L)
    if prefix == "erkfull":
        kern = erk_full_kernel(model, tab, L, torch.float64, ERK_FULL_PREFIX_STEPS, "cpu")
        p, gs = erk_full_inputs(kern.spec.num_opt)
        vals, ms = cpu_time(lambda: nll_kernel.nll_plain(kern.cm, kern.physical(torch.as_tensor(p)), kern.ys,
                                                         torch.as_tensor(gs)))
        return {"plain64": vals, "ms": ms}
    kern = erk_kernel(model, tab, L, torch.float64, ERK_PARITY_STEPS, ERK_PARITY_EVERY, "cpu")
    groups, cot = erk_parity_inputs(kern.spec.num_opt)
    phys = kern.physical(torch.as_tensor(np.concatenate([p for p, _ in groups])))
    gs = torch.as_tensor(np.concatenate([np.full(len(p), g) for p, g in groups]))
    vals, ms = cpu_time(lambda: nll_kernel.nll_plain(kern.cm, phys, kern.ys, gs))
    (dphys, dgamma), grad_ms = cpu_time(lambda: nll_kernel.nll_grad_plain(kern.cm, phys, kern.ys, gs,
                                                                          torch.as_tensor(cot)))
    # one lane's operations on the timing rig (the structure, not the type, sets them)
    timing = erk_kernel(model, tab, L, torch.float64, ERK_TIMING_STEPS, 1, "cpu")
    return {"plain64": vals, "grad64": torch.cat([dphys, dgamma[None]]), "ms": ms, "grad_ms": grad_ms,
            "fwd_ops": ops_per_lane(timing.cm), "grad_ops": grad_ops_per_lane(timing.cm)}


def erk_ref_groups() -> tuple:
    """erk_ref_keys dealt over ERK_REF_GROUPS processes, the dearest first."""
    keys = erk_ref_keys()
    cost = lambda k: (k.startswith("erk-") * 10 + ("dopri65" in k) * 4 + ("lorenz" in k) * 2
                      + (k == "pendulum_lanes") * 30)
    groups = [[] for _ in range(ERK_REF_GROUPS)]
    loads = [0] * ERK_REF_GROUPS
    for k in sorted(keys, key=cost, reverse=True):
        i = loads.index(min(loads))
        groups[i].append(k)
        loads[i] += cost(k) + 1
    return tuple(tuple(g) for g in groups)


# the keys of an entry of the kernels line
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def erk_entry(kernel: str, model: str, tableau: str, L: int, dtype) -> dict:
    """The kernels line's entry of one instantiation (without its numbers)."""
    unit = {"lotka_volterra": "lv", "van_der_pol": "vdp"}.get(model, model)
    dt = str(dtype).removeprefix("torch.")
    return {"name": f"{kernel} {model}/{tableau} L={L} {dt}", "route": "cuda",
            "source": f"ode_uncertainty_tpu_torch/csrc/{kernel}_erk_{unit}_{'f32' if dt == 'float32' else 'f64'}.cu",
            "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:" + ("722" if kernel == "nll_fwd" else "851"),
            "model": model, "tableau": tableau, "L": L, "dtype": dt, "library_ms": None}


def erk_phases(plain_procs: dict, ptxas: list) -> dict:
    """erk_parity, pendulum_optimize, pendulum_evaluate, erk_full_horizon and
    erk_timing; returns the entries of every new instantiation for the
    kernels line and the launches of rows 1 and 3 by path."""
    entries = {}  # (kernel, model, tableau, L, dtype name) -> kernels-line entry
    for model, tab, L in erk_chains():
        for kernel in ("nll_fwd", "nll_bwd"):
            for dtype in (torch.float32, torch.float64):
                e = erk_entry(kernel, model, tab, L, dtype)
                spill = next((p for p in ptxas if (p["kernel"], p["model"], p["tableau"], p["L"], p["dtype"])
                              == (kernel, model, tab, L, e["dtype"])), {})
                e.update(registers=spill.get("registers"), spill_stores=spill.get("spill_stores"), launches=0)
                entries[(kernel, model, tab, L, e["dtype"])] = e

    with Phase("erk_parity") as ph:
        worst = {}
        for model, tab, L in erk_chains():
            ref = plain_ref(plain_procs, erk_key("erk", model, tab, L))
            for dtype in (torch.float64, torch.float32):
                kern = erk_kernel(model, tab, L, dtype, ERK_PARITY_STEPS, ERK_PARITY_EVERY)
                groups, cot = erk_parity_inputs(kern.spec.num_opt)
                cot = torch.as_tensor(cot, dtype=dtype, device=DEVICE)
                vals, grads, start = [], [], 0
                for p, gs in groups:
                    phys = kern.physical(torch.as_tensor(p, dtype=dtype, device=DEVICE))
                    vals.append(kern.launch(phys, gs))
                    dphys, dgamma = kern.grad.launch(phys, gs, cot[start:start + len(p)], True)
                    grads.append(torch.cat([dphys, dgamma[None]]))
                    start += len(p)
                torch.cuda.synchronize()
                exact = dtype == torch.float64
                label = f"{model} {tab} L={L} {str(dtype)[6:]}"
                val = compare(torch.cat(vals), ref["plain64"], exact)
                grad = compare_grads(torch.cat(grads, dim=1), ref["grad64"], exact)
                for kernel, stat in (("nll_fwd", val), ("nll_bwd", grad)):
                    entries[(kernel, model, tab, L, str(dtype)[6:])]["max_abs_err"] = stat["max_abs_err"]
                    key = (kernel, str(dtype)[6:])
                    err = stat["max_rel_err" if exact else "p99_lane_err"]
                    if err >= worst.get(key, (-1.0,))[0]:
                        worst[key] = (err, label)
        ph.info.update(chains=len(erk_chains()), instantiations=len(entries), steps=ERK_PARITY_STEPS,
                       every=ERK_PARITY_EVERY, batches=list(ERK_BATCHES), gammas_sqrt=list(ERK_GAMMAS),
                       worst={f"{k} {d}": {"err": e, "chain": c} for (k, d), (e, c) in worst.items()},
                       limits={"f64": [RTOL_F64, GRAD_RTOL_F64], "f32_p99": [P99_F32, GRAD_P99_F32]},
                       plain_references="host CPU, processes of their own (ERK_REF_GROUPS)")

    paths = {}
    opt_path = OUT / "pendulum_optimize.npz"
    for stale in OUT.glob("pendulum_optimize.npz*"):
        stale.unlink()
    with Phase("pendulum_optimize") as ph:
        cfg = pendulum_config(opt_path)
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        with LaunchTimer() as timer:
            res = optimize(cfg)
        wall = time.perf_counter() - t0
        counts, by_chain = dict(nll_kernel.launches), dict(nll_kernel.launches_by_chain)
        kernel_s = timer.seconds()
        final = np.asarray(res["nll_optims"][:, -1], np.float64)
        if res["nll_optims"].shape != (100, 4) or res["params_optims"].shape != (100, 4, 1):
            raise AssertionError(f"pendulum optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if min(counts.values()) <= 0 or res["route"] != "nll_fwd + nll_bwd kernels":
            raise AssertionError(f"pendulum optimize did not run both kernels: {counts}, {res['route']}")
        finite = np.isfinite(final)
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of 100 pendulum restarts end finite")
        best = int(np.argmin(np.where(finite, final, np.inf)))
        kf = rpe.batched_nll(build_rig(cfg, torch.float32, torch.device(DEVICE)), cfg, grad=True)[0]
        truth = float(kf.launch(kf.physical(kf.spec.defaults_norm_opt()[None]), 0.0)[0])
        if not final[best] <= truth + 1e-3 * abs(truth):
            raise AssertionError(f"best final pendulum NLL {final[best]} above the NLL at length 3.0, {truth}")
        length = float(res["params_optims"][best, -1, 0])
        if abs(length - PENDULUM_LENGTH_TRUE) > 0.10 * PENDULUM_LENGTH_TRUE:
            raise AssertionError(f"best length {length} not within 10% of {PENDULUM_LENGTH_TRUE}")
        # a few lanes in float64 against the plain version on the host's CPU (full horizon)
        k64, p, gs = pendulum_lanes()
        ref = plain_ref(plain_procs, "pendulum_lanes")
        vals, grads = [], []
        for g in dict.fromkeys(gs.tolist()):  # the halves in order
            phys = k64.physical(torch.as_tensor(p[gs == g], device=DEVICE))
            vals.append(k64.launch(phys, g))
            dphys, dgamma = k64.grad.launch(phys, g, torch.ones(phys.shape[1], dtype=torch.float64, device=DEVICE),
                                            True)
            grads.append(torch.cat([dphys, dgamma[None]]))
        torch.cuda.synchronize()
        lanes = {"gamma_sqrt": gs.tolist(), "plain_cpu_ms": ref["ms"],
                 "value": compare(torch.cat(vals), ref["plain64"], True),
                 "gradient": compare_grads(torch.cat(grads, dim=1), ref["grad64"], True)}
        ph.info.update(launches=counts, route=res["route"], optimize_wall_s=wall, restarts=100, stages=4,
                       steps=kf.cm.n_obs, lbfgs_maxiter=cfg["lbfgs_maxiter"], finite_final=int(finite.sum()),
                       best_final_nll=float(final[best]), nll_at_length_3=truth, best_length=length,
                       units=res["units"], kernel_seconds=kernel_s, kernel_share=sum(kernel_s.values()) / wall,
                       device_idle_share_at_most=1.0 - sum(kernel_s.values()) / wall,
                       dispatches_per_stage=[u["dispatches"] for u in res["units"]],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       f64_lanes_vs_plain=lanes, output=str(opt_path.relative_to(ROOT)))
    paths["pendulum_optimize"] = (counts, by_chain)
    pend_widest = max(u["widest"] for u in res["units"])

    with Phase("pendulum_evaluate") as ph:
        out, total, total_by_chain = {}, {"nll_fwd": 0, "nll_bwd": 0}, {}
        for tab in ERK_TABLEAUS:
            path = OUT / f"pendulum_evaluate_{tab}.npz"
            path.unlink(missing_ok=True)
            cfg = pendulum_config(path, tab)
            nll_kernel.reset_launches()
            res = evaluate(cfg)
            counts, by_chain = dict(nll_kernel.launches), dict(nll_kernel.launches_by_chain)
            vals = res["nll_evals"]
            key = ("nll_fwd", "pendulum", tab, 2, 1, "float32")
            if vals.shape != (4, 100) or not np.isfinite(vals).all():
                raise AssertionError(f"pendulum evaluate ({tab}) gave shape {vals.shape}, finite {np.isfinite(vals).all()}")
            if by_chain != {key: 4} or res["route"] != "nll_fwd kernel":
                raise AssertionError(f"pendulum evaluate ({tab}) did not launch its instantiation 4 times: {by_chain}")
            length = res["param_evals"][:, 0]
            best = float(length[int(np.argmin(vals[-1]))])
            if abs(best - PENDULUM_LENGTH_TRUE) > 0.10 * PENDULUM_LENGTH_TRUE:
                raise AssertionError(f"pendulum evaluate ({tab}): last stage's argmin {best} not within 10% of 3.0")
            # the points equal a direct launch of the entry points' wrapper
            kd = rpe.batched_nll(build_rig(cfg, torch.float32, torch.device(DEVICE)), cfg)[0]
            grid = torch.as_tensor(np.linspace(0.0, 1.0, vals.shape[1])[:, None], dtype=torch.float32, device=DEVICE)
            direct = torch.stack([kd.launch(kd.physical(grid), float(torch.sqrt(gam)))
                                  for gam in gammas_of(cfg, torch.float32)]).cpu().numpy()
            if not np.array_equal(vals, direct):
                raise AssertionError(f"pendulum evaluate ({tab}) differs from a direct launch")
            for k in total:
                total[k] += counts[k]
            for k, v in by_chain.items():
                total_by_chain[k] = total_by_chain.get(k, 0) + v
            out[tab] = {"launches": counts, "wall_s": res["wall_s"], "argmin_length_last_stage": best,
                        "nll_min_per_stage": vals.min(axis=1).tolist(), "points_equal_direct_launch": True,
                        "output": str(path.relative_to(ROOT))}
        ph.info.update(shape=[4, 100], tableaus=out, generating_length=PENDULUM_LENGTH_TRUE)
    paths["pendulum_evaluate"] = (total, total_by_chain)

    with Phase("erk_full_horizon") as ph:
        rigs = [(model, tab, L) for model, n in (("lorenz", 3), ("van_der_pol", 2)) for tab in ERK_TABLEAUS
                for L in (1, n)]
        half = ERK_FULL_LANES // 2
        nll_kernel.reset_launches()
        full = {}
        for model, tab, L in rigs:
            kern = erk_full_kernel(model, tab, L, torch.float64)
            pt = torch.as_tensor(erk_full_inputs(kern.spec.num_opt)[0], device=DEVICE)
            full[(model, tab, L)] = (kern.cm, torch.cat([kern.launch(kern.physical(pt[:half]), 0.1),
                                                        kern.launch(kern.physical(pt[half:]), 0.0)]))
        torch.cuda.synchronize()
        paths["erk_full_horizon"] = (dict(nll_kernel.launches), dict(nll_kernel.launches_by_chain))
        out = {}
        for (model, tab, L), (cm, vals) in full.items():
            if not torch.isfinite(vals).all():
                raise AssertionError(f"erk_full_horizon {model} {tab} L={L}: non-finite NLL {vals.tolist()}")
            # the cut prefix against the plain version on the host's CPU
            short = erk_full_kernel(model, tab, L, torch.float64, ERK_FULL_PREFIX_STEPS)
            pt = torch.as_tensor(erk_full_inputs(short.spec.num_opt)[0], device=DEVICE)
            prefix = torch.cat([short.launch(short.physical(pt[:half]), 0.1),
                                short.launch(short.physical(pt[half:]), 0.0)])
            stat = compare(prefix, plain_ref(plain_procs, erk_key("erkfull", model, tab, L))["plain64"], True)
            out[f"{model} {tab} L={L}"] = {"steps": cm.n_obs, "t0": cm.t0, "nll_min": float(vals.min()),
                                           "nll_max": float(vals.max()), "prefix_steps": ERK_FULL_PREFIX_STEPS,
                                           "prefix_vs_plain_f64_max_rel_err": stat["max_rel_err"]}
        ph.info.update(rigs=out, lanes=ERK_FULL_LANES, dtype="float64",
                       observations="data/lorenz.npz, data/vanderpol.npz (results/noise_gt)")

    with Phase("erk_timing") as ph:
        for model, tab, L in erk_chains():
            ref = plain_ref(plain_procs, erk_key("erk", model, tab, L))
            for dtype in (torch.float32, torch.float64):
                dt = str(dtype)[6:]
                kern = erk_kernel(model, tab, L, dtype, ERK_TIMING_STEPS, 1)
                p = torch.as_tensor(np.random.default_rng(SEED).uniform(size=(ERK_TIMING_BATCH, kern.spec.num_opt)),
                                    dtype=dtype, device=DEVICE)
                phys, g = kern.physical(p), torch.ones(ERK_TIMING_BATCH, dtype=dtype, device=DEVICE)
                fwd = lambda: kern.launch(phys, 0.1)
                bwd = lambda: kern.grad.launch(phys, 0.1, g, False)
                fwd(), bwd()
                torch.cuda.synchronize()
                for kernel, launch, plain, ops_key in (
                        ("nll_fwd", fwd, lambda c: nll_kernel.nll_plain(c, phys, kern.ys, 0.1), "fwd_ops"),
                        ("nll_bwd", bwd, lambda c: nll_kernel.nll_grad_plain(c, phys, kern.ys, 0.1, g), "grad_ops")):
                    ms = event_times(launch, ERK_TIMING_REPS)
                    _, plain_ms = sync_time(lambda: plain(cut(kern.cm, ERK_PLAIN_TIMING_STEPS)))
                    b_ms, b_by, _ = bound_ms(kern.cm, ERK_TIMING_BATCH, grad=kernel == "nll_bwd",
                                             lane_ops=ref[ops_key])
                    entries[(kernel, model, tab, L, dt)].update(
                        ms=float(np.median(ms)), plain_ms=plain_ms, plain_steps=ERK_PLAIN_TIMING_STEPS,
                        bound_ms=b_ms, bound_by=b_by)
        ranges = {}
        for e in entries.values():
            lo, hi = ranges.get(f"{e['name'][:7]} {e['dtype']}", (np.inf, -np.inf))
            ranges[f"{e['name'][:7]} {e['dtype']}"] = (min(lo, e["ms"]), max(hi, e["ms"]))
        pend = entries[("nll_fwd", "pendulum", "rkf45", 1, "float32")], entries[("nll_bwd", "pendulum", "rkf45", 1, "float32")]
        ph.info.update(shape=f"B={ERK_TIMING_BATCH}, {ERK_TIMING_STEPS} steps, a correct a step, every row "
                             "(nll_bwd, without d/d gamma^1/2), gamma^1/2 = 0.1",
                       reps=ERK_TIMING_REPS, library_call="none", ms_range=ranges,
                       pendulum_rkf45_f32={e["name"][:7]: {k: e[k] for k in ("ms", "bound_ms", "plain_ms")} for e in pend},
                       per_instantiation=str((OUT / "erk_instantiations.json").relative_to(ROOT)))
    for _, by_chain in paths.values():
        for key, count in by_chain.items():
            kernel, model, tab, _, L, dt = key
            if (kernel, model, tab, L, dt) in entries:
                entries[(kernel, model, tab, L, dt)]["launches"] += count
    (OUT / "erk_instantiations.json").write_text(json.dumps(list(entries.values()), indent=1))
    return {"entries": list(entries.values()),
            "paths": {name: counts for name, (counts, _) in paths.items()}, "pendulum_widest": pend_widest}


PLAIN_REF_GROUPS = PLAIN_REF_GROUPS + erk_ref_groups()


# ---- the team chains of rows 2 and 4 on the tile models, and of rows 1 and 3 on HH ----
# chip label -> (experiment, committed observations) of each single-compartment HH variant
TEAM_HH = {"hh4": ("params/hodgkinhuxley1_r4", "hodgkinhuxley_r4.npz"),
           "hh7": ("params/hodgkinhuxley6_r1", "hodgkinhuxley_r1.npz"),
           "hh8": ("params/hodgkinhuxley7_full", "hodgkinhuxley_full.npz")}
TEAM_HH_MODELS = {"hh4": "hodgkin_huxley_reduced-4", "hh7": "hodgkin_huxley_reduced-1",
                  "hh8": "hodgkin_huxley_full"}
TEAM_HH_T0 = 9.98  # the HH rigs start two steps before the stimulus edge at t = 10
TEAM_TILE_STEPS, TEAM_HH_STEPS = 50, 6  # team_parity's horizons (an observation every ERK_PARITY_EVERY / every step)
# team_timing's HH horizons from rest: the experiment's 10^4 steps on reduced-4; 2,000 on reduced-1 and full,
# whose explicit chains from rest turn non-finite near step 2,420 (the reference's own solve blows up there)
TEAM_HH_TIMING_STEPS = {"hh4": 10_000, "hh7": 2_000, "hh8": 2_000}
TEAM_HH_TIMING_REPS = 3  # a launch is 30-360 ms
TEAM_REF_GROUPS = 4  # processes of the team plain references
LVKV3_LANES = 4  # float64 lanes of lv_kv3_optimize's rig held to the plain version at full horizon
# float64 lanes of hh_rkf45's rig held to the plain version: HH_RKF45_LANES_STEPS steps from t0 across the
# stimulus onset at t = 10, times by the entry points' running sum (the plain version costs ~0.7 s a step)
HH_RKF45_LANES, HH_RKF45_LANES_T0, HH_RKF45_LANES_STEPS = 4, 9.0, 200
HH_RKF45_LBFGS_MAXITER = 10  # hh_rkf45_optimize's depth (the experiment's: 200)
SOLVER_CLASS = "ode_uncertainty_tpu.solvers.{}"


def team_chains() -> list:
    """(model, tableau, L) of the chains on a team of threads per lane
    beside HH x Kvaerno3: Kvaerno3 on every tile model at every L in 1..n,
    and every explicit tableau on each single-compartment HH variant at
    L = 1."""
    return ([(m, "kvaerno3", L) for m, (_, x0) in ERK_MODELS.items() for L in range(1, int(np.size(x0)) + 1)]
            + [(hh, tab, 1) for hh in TEAM_HH for tab in ERK_TABLEAUS])


def team_kernel(model: str, tableau: str, L: int, dtype, steps: int, device=None, t0: float = None):
    """The kernels' wrapper of a team chain: a tile model on erk_kernel's rig
    (an observation every ERK_PARITY_EVERY steps), an HH variant on its
    experiment's rig (hh_kernel: the experiment's optimized parameters, V
    observed after every step) from ``t0`` (TEAM_HH_T0) under ``tableau``."""
    if model not in TEAM_HH:
        return erk_kernel(model, tableau, L, dtype, steps, ERK_PARITY_EVERY, device)
    experiment, data = TEAM_HH[model]
    cfg = hh_config(experiment, data)
    cfg["solver_builder"] = getattr(solvers, tableau)(cfg["solver_builder"].h)
    return hh_kernel(cfg, dtype, TEAM_HH_T0 if t0 is None else t0, steps, data=data, device=device)


def team_timing_kernel(model: str, tableau: str, L: int, dtype, device=None):
    """team_timing's rig: erk_timing's (ERK_TIMING_STEPS, a correct a step)
    on a tile model, TEAM_HH_TIMING_STEPS from rest on HH."""
    if model in TEAM_HH:
        return team_kernel(model, tableau, L, dtype, TEAM_HH_TIMING_STEPS[model], device, t0=0.0)
    return erk_kernel(model, tableau, L, dtype, ERK_TIMING_STEPS, 1, device)


def lv_kv3_config(out_path: Path, float64: bool = False, device: str = None):
    """params/lotkavolterra2 with ``--set solver_builder`` Kvaerno3 at its
    h = 0.01, on the synthesized observations."""
    raw = load_experiment("params/lotkavolterra2")
    raw["solver_builder"] = {"class_path": SOLVER_CLASS.format("Kvaerno3"),
                             "init_args": {"step_size": raw["solver_builder"]["init_args"]["step_size"]}}
    return build_config(raw, {"y_path": str(LV2_OBS), "output": str(out_path),
                              "device": DEVICE if device is None else device, "float64": float64})


def hh_rkf45_config(out_path: Path, device: str = None):
    """params/hodgkinhuxley1_r4 with ``--set solver_builder`` RKF45 at its
    h = 0.01, on the committed npz observations."""
    raw = load_experiment(HH_EXPERIMENT)
    raw["solver_builder"] = {"class_path": SOLVER_CLASS.format("RKF45"),
                             "init_args": {"step_size": raw["solver_builder"]["init_args"]["step_size"]}}
    return build_config(raw, {"y_path": str(HH_DATA / "hodgkinhuxley_r4.npz"), "output": str(out_path),
                              "device": DEVICE if device is None else device})


def lv_kv3_lanes(device: str = None) -> tuple:
    """lv_kv3_optimize's float64 check: the entry points' wrapper on the
    experiment's rig, LVKV3_LANES points, and their gamma^1/2: the first
    stage's for the first half, the last stage's for the rest."""
    cfg = lv_kv3_config(OUT / "unused.npz", float64=True, device=device)
    kern = rpe.batched_nll(build_rig(cfg, torch.float64, torch.device(cfg["device"])), cfg, grad=True)[0]
    p = np.random.default_rng(SEED + 7).uniform(size=(LVKV3_LANES, 2))
    gammas = gammas_of(cfg, torch.float64)
    half = LVKV3_LANES // 2
    return kern, p, np.repeat([float(torch.sqrt(gammas[0])), float(torch.sqrt(gammas[-1]))], [half, half])


def hh_rkf45_lanes(device: str = None) -> tuple:
    """hh_rkf45_optimize's float64 check: the experiment's rig under RKF45
    over HH_RKF45_LANES_STEPS steps from HH_RKF45_LANES_T0, with the entry
    points' running-sum time rule, HH_RKF45_LANES points, and their
    gamma^1/2: the first stage's for the first half, the last stage's for
    the rest."""
    cfg = hh_rkf45_config(OUT / "unused.npz", device=device)
    kern = hh_kernel(cfg, torch.float64, HH_RKF45_LANES_T0, HH_RKF45_LANES_STEPS, accumulate_time=True,
                     device=device)
    p = np.random.default_rng(SEED + 8).uniform(size=(HH_RKF45_LANES, kern.spec.num_opt))
    gammas = gammas_of(cfg, torch.float64)
    half = HH_RKF45_LANES // 2
    return kern, p, np.repeat([float(torch.sqrt(gammas[0])), float(torch.sqrt(gammas[-1]))], [half, half])


# the float64 lane checks of the two paths' phases: plain-reference key -> its rig
TEAM_LANES = {"lvkv3_lanes": lv_kv3_lanes, "hhrkf45_lanes": hh_rkf45_lanes}


def team_ref_keys() -> list:
    """The plain references of the team phases: team_parity's (``team-*``,
    with the timing rigs' operation counts) and the paths' lanes (TEAM_LANES)."""
    return [erk_key("team", *c) for c in team_chains()] + list(TEAM_LANES)


def team_plain_reference(key: str) -> dict:
    """One team plain reference on the host's CPU, float64."""
    if key in TEAM_LANES:
        kern, p, gs = TEAM_LANES[key]("cpu")
        phys, gs = kern.physical(torch.as_tensor(p)), torch.as_tensor(gs)
        (vals, (dphys, dgamma)), ms = cpu_time(lambda: (
            nll_kernel.nll_plain(kern.cm, phys, kern.ys, gs),
            nll_kernel.nll_grad_plain(kern.cm, phys, kern.ys, gs, torch.ones(len(p), dtype=torch.float64))))
        return {"plain64": vals, "grad64": torch.cat([dphys, dgamma[None]]), "ms": ms}
    _, model, tab, L = key.split("-")
    L = int(L)
    steps = TEAM_HH_STEPS if model in TEAM_HH else TEAM_TILE_STEPS
    kern = team_kernel(model, tab, L, torch.float64, steps, "cpu")
    groups, cot = erk_parity_inputs(kern.spec.num_opt)
    phys = kern.physical(torch.as_tensor(np.concatenate([p for p, _ in groups])))
    gs = torch.as_tensor(np.concatenate([np.full(len(p), g) for p, g in groups]))
    vals, ms = cpu_time(lambda: nll_kernel.nll_plain(kern.cm, phys, kern.ys, gs))
    (dphys, dgamma), grad_ms = cpu_time(lambda: nll_kernel.nll_grad_plain(kern.cm, phys, kern.ys, gs,
                                                                          torch.as_tensor(cot)))
    timing = team_timing_kernel(model, tab, L, torch.float64, "cpu")
    return {"plain64": vals, "grad64": torch.cat([dphys, dgamma[None]]), "ms": ms, "grad_ms": grad_ms,
            "lanes": phys.shape[1], "steps": steps,
            "fwd_ops": ops_per_lane(timing.cm), "grad_ops": grad_ops_per_lane(timing.cm)}


def team_ref_groups() -> tuple:
    """team_ref_keys dealt over TEAM_REF_GROUPS processes, the dearest first
    (the HH plain versions' JVPs run column by column: n = 7 and 8 under
    Dormand-Prince cost seconds a step)."""
    def cost(k):
        if k in TEAM_LANES:
            return {"lvkv3_lanes": 90, "hhrkf45_lanes": 150}[k]
        _, model, tab, _ = k.split("-")
        size = {"hh4": 3, "hh7": 10, "hh8": 12}.get(model, 1)
        return size * {"heun_euler": 1, "bs32": 2, "rkf45": 4, "dopri65": 6, "kvaerno3": 4}[tab]
    groups = [[] for _ in range(TEAM_REF_GROUPS)]
    loads = [0] * TEAM_REF_GROUPS
    for k in sorted(team_ref_keys(), key=cost, reverse=True):
        i = loads.index(min(loads))
        groups[i].append(k)
        loads[i] += cost(k)
    return tuple(tuple(g) for g in groups)


def steps_of_chain(cm) -> int:
    """The solver steps of a chain: first + 1, then n_obs - 1 intervals of d."""
    return cm.first + 1 + (cm.n_obs - 1) * cm.d


def team_entry(kernel: str, model: str, tableau: str, L: int, dtype) -> dict:
    """The kernels line's entry of one team instantiation (without its numbers)."""
    dt = str(dtype).removeprefix("torch.")
    tag = "f32" if dt == "float32" else "f64"
    if model in TEAM_HH:
        step = "dopri65" if kernel == "nll_bwd" and tableau == "dopri65" else "erk"
        source = f"{kernel}_{step}_{model}_{tag}.cu"
        name = TEAM_HH_MODELS[model]
    else:
        source = f"{kernel}_kv3_{ {'lotka_volterra': 'lv', 'van_der_pol': 'vdp'}.get(model, model)}_{tag}.cu"
        name = model
    step_ref = " (Kvaerno3 step, :291-364)" if tableau == "kvaerno3" else " (ERK step, :171)"
    return {"name": f"{kernel} {name}/{tableau} L={L} {dt}", "route": "cuda",
            "source": f"ode_uncertainty_tpu_torch/csrc/{source}",
            "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:" + ("722" if kernel == "nll_fwd" else "851") + step_ref,
            "model": name, "tableau": tableau, "L": L, "dtype": dt, "design": "team per lane", "library_ms": None}


def optimize_recording_starts(cfg) -> tuple:
    """optimize(cfg) with the normalized points each (chunk x stage) unit
    starts from recorded by stage: (result, {gamma: [points]}, launches,
    launches by chain, wall seconds, the kernels' device seconds)."""
    starts: dict = {}
    stage_grid = rpe.run_stage_grid

    def recording_grid(out, p0, gammas, stage_fn, *args, **kwargs):
        def recorded(p_norm, gamma, unit_key=None):
            starts.setdefault(float(gamma), []).append(p_norm.detach().clone())
            return stage_fn(p_norm, gamma, unit_key=unit_key)
        return stage_grid(out, p0, gammas, recorded, *args, **kwargs)

    rpe.run_stage_grid = recording_grid
    try:
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        with LaunchTimer() as timer:
            res = optimize(cfg)
        wall = time.perf_counter() - t0
        counts, by_chain = dict(nll_kernel.launches), dict(nll_kernel.launches_by_chain)
    finally:
        rpe.run_stage_grid = stage_grid
    return res, starts, counts, by_chain, wall, timer.seconds()


def stage_descent(kern, res, starts) -> list:
    """Per stage: the best NLL of the points the stage started from (by the
    wrapper ``kern``, float32, at the stage's gamma^1/2) and the best at its
    end; raises unless every stage descends."""
    final_all = np.asarray(res["nll_optims"], np.float64)
    descent = []
    for stage, gam in enumerate(res["gammas"].tolist()):
        gs = float(torch.sqrt(torch.as_tensor(gam, dtype=torch.float32)))
        p_start = torch.cat(starts[float(np.float32(gam))]).to(device=DEVICE, dtype=torch.float32)
        start = kern.launch(kern.physical(p_start), gs).double().cpu().numpy()
        best_start = float(np.min(np.where(np.isfinite(start), start, np.inf)))
        col = final_all[:, stage]
        best_final = float(np.min(np.where(np.isfinite(col), col, np.inf)))
        descent.append({"stage": stage, "gamma": gam, "best_start_nll": best_start, "best_final_nll": best_final,
                        "finite_start": int(np.isfinite(start).sum()), "finite_final": int(np.isfinite(col).sum())})
        if not best_final <= best_start:
            raise AssertionError(f"optimize did not descend at stage {stage}: {descent[-1]}")
    return descent


# the instantiations of the two paths (launches_by_chain keys: nll_fwd, nll_bwd)
LV_KV3_CHAIN = tuple((k, "lotka_volterra", "kvaerno3", 2, 1, "float32") for k in ("nll_fwd", "nll_bwd"))
HH_RKF45_CHAIN = tuple((k, "hodgkin_huxley_reduced-4", "rkf45", 4, 1, "float32") for k in ("nll_fwd", "nll_bwd"))


def team_limits(tab: str) -> tuple:
    """team_parity's float32 p99 limits (values, gradients): implicit or explicit."""
    return (HH_P99_F32, HH_GRAD_P99_F32) if tab == "kvaerno3" else (P99_F32, GRAD_P99_F32)


def team_parity_phase(plain_procs: dict, entries: dict) -> None:
    """Every team instantiation against its float64 plain version (team_ref_keys)."""
    with Phase("team_parity") as ph:
        worst = {}
        for model, tab, L in team_chains():
            ref = plain_ref(plain_procs, erk_key("team", model, tab, L))
            steps = TEAM_HH_STEPS if model in TEAM_HH else TEAM_TILE_STEPS
            for dtype in (torch.float64, torch.float32):
                kern = team_kernel(model, tab, L, dtype, steps)
                groups, cot = erk_parity_inputs(kern.spec.num_opt)
                cot = torch.as_tensor(cot, dtype=dtype, device=DEVICE)
                vals, grads, start = [], [], 0
                for p, gs in groups:
                    phys = kern.physical(torch.as_tensor(p, dtype=dtype, device=DEVICE))
                    vals.append(kern.launch(phys, gs))
                    dphys, dgamma = kern.grad.launch(phys, gs, cot[start:start + len(p)], True)
                    grads.append(torch.cat([dphys, dgamma[None]]))
                    start += len(p)
                torch.cuda.synchronize()
                exact = dtype == torch.float64
                dt = str(dtype)[6:]
                val_limit, grad_limit = team_limits(tab)
                val = compare(torch.cat(vals), ref["plain64"], exact, val_limit)
                grad = compare_grads(torch.cat(grads, dim=1), ref["grad64"], exact, grad_limit)
                for kernel, stat in (("nll_fwd", val), ("nll_bwd", grad)):
                    entries[(kernel, kern.cm.model_name, tab, L, dt)]["max_abs_err"] = stat["max_abs_err"]
                    key = (kernel, dt, "implicit" if tab == "kvaerno3" else "explicit")
                    err = stat["max_rel_err" if exact else "p99_lane_err"]
                    if err >= worst.get(key, (-1.0,))[0]:
                        worst[key] = (err, f"{model} {tab} L={L}")
        ph.info.update(chains=len(team_chains()), instantiations=len(entries),
                       steps={"tile": TEAM_TILE_STEPS, "hh": TEAM_HH_STEPS}, hh_t0=TEAM_HH_T0,
                       every={"tile": ERK_PARITY_EVERY, "hh": 1}, batches=list(ERK_BATCHES),
                       gammas_sqrt=list(ERK_GAMMAS),
                       worst={" ".join(k): {"err": e, "chain": c} for k, (e, c) in worst.items()},
                       limits={"f64": [RTOL_F64, GRAD_RTOL_F64], "f32_p99_implicit": list(team_limits("kvaerno3")),
                               "f32_p99_explicit": list(team_limits("rkf45"))},
                       plain_references="host CPU, processes of their own (TEAM_REF_GROUPS)")



def f64_lanes_vs_plain(plain_procs: dict, key: str) -> dict:
    """The float64 lanes of TEAM_LANES[key] on the card, values and every
    row's gradient, against their plain reference (1e-9, 1e-8)."""
    k64, p, gs = TEAM_LANES[key]()
    ref = plain_ref(plain_procs, key)
    vals, grads = [], []
    for g in dict.fromkeys(gs.tolist()):  # the halves in order
        phys = k64.physical(torch.as_tensor(p[gs == g], device=DEVICE))
        vals.append(k64.launch(phys, g))
        dphys, dgamma = k64.grad.launch(phys, g, torch.ones(phys.shape[1], dtype=torch.float64, device=DEVICE), True)
        grads.append(torch.cat([dphys, dgamma[None]]))
    torch.cuda.synchronize()
    return {"gamma_sqrt": gs.tolist(), "steps": steps_of_chain(k64.cm), "plain_cpu_ms": ref["ms"],
            "value": compare(torch.cat(vals), ref["plain64"], True),
            "gradient": compare_grads(torch.cat(grads, dim=1), ref["grad64"], True)}


def lv_kv3_phases(plain_procs: dict) -> dict:
    """lv_kv3_optimize and lv_kv3_evaluate; {phase: (launches, by chain)}."""
    paths = {}
    lv_fwd = LV_KV3_CHAIN[0]
    opt_path = OUT / "lv_kv3_optimize.npz"
    for stale in OUT.glob("lv_kv3_optimize.npz*"):
        stale.unlink()
    with Phase("lv_kv3_optimize") as ph:
        cfg = lv_kv3_config(opt_path)
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        with LaunchTimer() as timer:
            res = optimize(cfg)
        wall = time.perf_counter() - t0
        counts, by_chain = dict(nll_kernel.launches), dict(nll_kernel.launches_by_chain)
        kernel_s = timer.seconds()
        final = np.asarray(res["nll_optims"][:, -1], np.float64)
        if res["nll_optims"].shape != (100, 4) or res["params_optims"].shape != (100, 4, 2):
            raise AssertionError(f"LV Kvaerno3 optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if (set(by_chain) != set(LV_KV3_CHAIN) or min(by_chain.values()) <= 0
                or res["route"] != "nll_fwd + nll_bwd kernels"):
            raise AssertionError(f"LV Kvaerno3 optimize did not run its two instantiations: {by_chain}, {res['route']}")
        finite = np.isfinite(final)
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of 100 LV Kvaerno3 restarts end finite")
        best = int(np.argmin(np.where(finite, final, np.inf)))
        kern = rpe.batched_nll(build_rig(cfg, torch.float32, torch.device(DEVICE)), cfg, grad=True)[0]
        truth = float(kern.launch(kern.physical(kern.spec.defaults_norm_opt()[None]), 0.0)[0])
        if not final[best] <= truth + 1e-3 * abs(truth):
            raise AssertionError(f"best final LV Kvaerno3 NLL {final[best]} above the generating parameters' {truth}")
        generating = kern.spec.defaults_flat[kern.spec.opt_indices].cpu().numpy()
        optimum = res["params_optims"][best, -1]
        rel = np.abs(optimum - generating) / generating
        if rel.max() > 0.10:
            raise AssertionError(f"best LV Kvaerno3 optimum {optimum} not within 10% of {generating}")
        # a few lanes in float64 against the plain version on the host's CPU (full horizon)
        lanes = f64_lanes_vs_plain(plain_procs, "lvkv3_lanes")
        ph.info.update(launches=counts, route=res["route"], optimize_wall_s=wall, restarts=100, stages=4,
                       steps=steps_of_chain(kern.cm), lbfgs_maxiter=cfg["lbfgs_maxiter"],
                       finite_final=int(finite.sum()), best_final_nll=float(final[best]),
                       nll_at_generating_params=truth, best_optimum=optimum.tolist(),
                       generating=generating.tolist(), optimum_rel_err=rel.tolist(), units=res["units"],
                       kernel_seconds=kernel_s, kernel_share=sum(kernel_s.values()) / wall,
                       device_idle_share_at_most=1.0 - sum(kernel_s.values()) / wall,
                       dispatches_per_stage=[u["dispatches"] for u in res["units"]],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       f64_lanes_vs_plain=lanes, output=str(opt_path.relative_to(ROOT)))
    paths["lv_kv3_optimize"] = (counts, by_chain)

    eval_path = OUT / "lv_kv3_evaluate.npz"
    eval_path.unlink(missing_ok=True)
    with Phase("lv_kv3_evaluate") as ph:
        cfg = lv_kv3_config(eval_path)
        nll_kernel.reset_launches()
        res = evaluate(cfg)
        counts, by_chain = dict(nll_kernel.launches), dict(nll_kernel.launches_by_chain)
        vals = res["nll_evals"]
        if vals.shape != (4, 400) or not np.isfinite(vals).all():
            raise AssertionError(f"LV Kvaerno3 evaluate gave shape {vals.shape}, finite {np.isfinite(vals).all()}")
        if set(by_chain) != {lv_fwd} or counts["nll_fwd"] <= 0 or res["route"] != "nll_fwd kernel":
            raise AssertionError(f"LV Kvaerno3 evaluate did not run its instantiation: {by_chain}, {res['route']}")
        # GRID_CHECK points of the grid equal a direct launch of the entry points' wrapper
        grid_idx, _, grid_norm, _ = lv2_grid(cfg)
        kd = rpe.batched_nll(build_rig(cfg, torch.float32, torch.device(DEVICE)), cfg)[0]
        pts = torch.as_tensor(grid_norm, dtype=torch.float32, device=DEVICE)
        direct = torch.stack([kd.launch(kd.physical(pts), float(torch.sqrt(gam)))
                              for gam in gammas_of(cfg, torch.float32)]).cpu().numpy()
        if not np.array_equal(vals[:, grid_idx], direct):
            raise AssertionError("LV Kvaerno3 evaluate differs from a direct launch")
        ph.info.update(launches=counts, route=res["route"], shape=list(vals.shape), evaluate_wall_s=res["wall_s"],
                       grid_points_equal_direct_launch=len(grid_idx), nll_min=float(vals.min()),
                       nll_max=float(vals.max()), output=str(eval_path.relative_to(ROOT)))
    paths["lv_kv3_evaluate"] = (counts, by_chain)

    return paths


def hh_rkf45_phases(plain_procs: dict) -> dict:
    """hh_rkf45_evaluate and hh_rkf45_optimize; {phase: (launches, by chain)}."""
    paths = {}
    hh_fwd = HH_RKF45_CHAIN[0]
    hh_eval_path = OUT / "hh_rkf45_evaluate.npz"
    hh_eval_path.unlink(missing_ok=True)
    with Phase("hh_rkf45_evaluate") as ph:
        cfg = hh_rkf45_config(hh_eval_path)
        nll_kernel.reset_launches()
        res = evaluate(cfg)
        counts, by_chain = dict(nll_kernel.launches), dict(nll_kernel.launches_by_chain)
        vals = res["nll_evals"]
        # a point of the grid may diverge under RKF45 (the JAX CLI's float32
        # run on the CPU has one non-finite point at stages 0 and 2)
        finite = np.isfinite(vals)
        if vals.shape != (4, 100) or not finite[-1].any():
            raise AssertionError(f"HH RKF45 evaluate gave shape {vals.shape}, finite {finite.sum(axis=1)}")
        if by_chain != {hh_fwd: 4} or res["route"] != "nll_fwd kernel":
            raise AssertionError(f"HH RKF45 evaluate did not launch its instantiation 4 times: {by_chain}")
        g_na = res["param_evals"][:, 0]
        best = float(g_na[int(np.argmin(np.where(finite[-1], vals[-1], np.inf)))])
        if abs(best - HH_GNA_TRUE) > 0.10 * HH_GNA_TRUE:
            raise AssertionError(f"HH RKF45 evaluate: last stage's argmin g_Na {best} not within 10% of {HH_GNA_TRUE}")
        kd = rpe.batched_nll(build_rig(cfg, torch.float32, torch.device(DEVICE)), cfg)[0]
        grid = torch.as_tensor(np.linspace(0.0, 1.0, vals.shape[1])[:, None], dtype=torch.float32, device=DEVICE)
        direct = torch.stack([kd.launch(kd.physical(grid), float(torch.sqrt(gam)))
                              for gam in gammas_of(cfg, torch.float32)]).cpu().numpy()
        if not np.array_equal(vals, direct, equal_nan=True):
            raise AssertionError("HH RKF45 evaluate differs from a direct launch")
        ph.info.update(launches=counts, route=res["route"], shape=list(vals.shape), steps=kd.cm.n_obs,
                       finite_per_stage=finite.sum(axis=1).tolist(), evaluate_wall_s=res["wall_s"],
                       points_equal_direct_launch=True, argmin_g_na_last_stage=best,
                       generating_g_na=HH_GNA_TRUE, nll_min_per_stage=np.nanmin(vals, axis=1).tolist(),
                       output=str(hh_eval_path.relative_to(ROOT)))
    paths["hh_rkf45_evaluate"] = (counts, by_chain)

    hh_opt_path = OUT / "hh_rkf45_optimize.npz"
    for stale in OUT.glob("hh_rkf45_optimize.npz*"):
        stale.unlink()
    with Phase("hh_rkf45_optimize") as ph:
        cfg = hh_rkf45_config(hh_opt_path)
        cfg["lbfgs_maxiter"] = HH_RKF45_LBFGS_MAXITER
        res, starts, counts, by_chain, wall, kernel_s = optimize_recording_starts(cfg)
        if res["nll_optims"].shape != (100, 4) or res["params_optims"].shape != (100, 4, 1):
            raise AssertionError(f"HH RKF45 optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if (set(by_chain) != set(HH_RKF45_CHAIN) or min(by_chain.values()) <= 0
                or res["route"] != "nll_fwd + nll_bwd kernels"):
            raise AssertionError(f"HH RKF45 optimize did not run its two instantiations: {by_chain}, {res['route']}")
        final = np.asarray(res["nll_optims"][:, -1], np.float64)
        finite = np.isfinite(final)
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of 100 HH RKF45 restarts end finite")
        kf = rpe.batched_nll(build_rig(cfg, torch.float32, torch.device(DEVICE)), cfg, grad=True)[0]
        descent = stage_descent(kf, res, starts)
        best = int(np.argmin(np.where(finite, final, np.inf)))
        # a few lanes in float64 against the plain version on the host's CPU, across the onset
        lanes = f64_lanes_vs_plain(plain_procs, "hhrkf45_lanes")
        ph.info.update(launches=counts, route=res["route"], optimize_wall_s=wall, restarts=100, stages=4,
                       steps=kf.cm.n_obs, lbfgs_maxiter=HH_RKF45_LBFGS_MAXITER, finite_final=int(finite.sum()),
                       descent=descent, best_final_nll=float(final[best]),
                       f64_lanes_vs_plain={**lanes, "t0": HH_RKF45_LANES_T0},
                       best_g_na_reported=float(res["params_optims"][best, -1, 0]), units=res["units"],
                       kernel_seconds=kernel_s, kernel_share=sum(kernel_s.values()) / wall,
                       device_idle_share_at_most=1.0 - sum(kernel_s.values()) / wall,
                       dispatches_per_stage=[u["dispatches"] for u in res["units"]],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       output=str(hh_opt_path.relative_to(ROOT)))
    paths["hh_rkf45_optimize"] = (counts, by_chain)

    return paths


def team_timing_phase(plain_procs: dict, entries: dict) -> None:
    """Every team instantiation timed at B = 256 (team_timing_kernel's rigs)."""
    with Phase("team_timing") as ph:
        for model, tab, L in team_chains():
            ref = plain_ref(plain_procs, erk_key("team", model, tab, L))
            hh = model in TEAM_HH
            for dtype in (torch.float32, torch.float64):
                dt = str(dtype)[6:]
                kern = team_timing_kernel(model, tab, L, dtype)
                p = torch.as_tensor(np.random.default_rng(SEED).uniform(size=(ERK_TIMING_BATCH, kern.spec.num_opt)),
                                    dtype=dtype, device=DEVICE)
                phys, g = kern.physical(p), torch.ones(ERK_TIMING_BATCH, dtype=dtype, device=DEVICE)
                rows = kern.opt_rows if hh else None  # HH: the experiment's optimized rows
                fwd = lambda: kern.launch(phys, 0.1)
                bwd = lambda: kern.grad.launch(phys, 0.1, g, False, rows)
                # no warm-up launch: team_parity has loaded every instantiation; how many of the timed
                # lanes end finite is recorded beside the time
                finite = int(torch.isfinite(fwd()).sum())
                for kernel, launch, plain_key, ops_key in (("nll_fwd", fwd, "ms", "fwd_ops"),
                                                            ("nll_bwd", bwd, "grad_ms", "grad_ops")):
                    ms = event_times(launch, TEAM_HH_TIMING_REPS if hh else ERK_TIMING_REPS)
                    grad = kernel == "nll_bwd"
                    # one reverse-mode sweep gives every row: its count bounds any direction list
                    b_ms, b_by, _ = bound_ms(kern.cm, ERK_TIMING_BATCH, grad=grad, lane_ops=ref[ops_key])
                    shape = f"B={ERK_TIMING_BATCH}, {steps_of_chain(kern.cm)} steps"
                    if grad:
                        shape += f", {len(rows)} rows" if hh else ", every row"
                    entries[(kernel, kern.cm.model_name, tab, L, dt)].update(
                        ms=float(np.median(ms)), plain_ms=ref[plain_key], timing_shape=shape,
                        plain_shape=f"host CPU, float64, {ref['lanes']} lanes, {ref['steps']} steps (team_parity's rig)",
                        bound_ms=b_ms, bound_by=b_by, timed_lanes_finite=finite)
        ranges = {}
        for e in entries.values():
            k = f"{e['name'][:7]} {e['tableau'] == 'kvaerno3' and 'kvaerno3' or 'hh-erk'} {e['dtype']}"
            lo, hi = ranges.get(k, (np.inf, -np.inf))
            ranges[k] = (min(lo, e["ms"]), max(hi, e["ms"]))
        path_entries = {k: entries[k[:3] + k[4:]] for k in LV_KV3_CHAIN + HH_RKF45_CHAIN}
        ph.info.update(shape=(f"B={ERK_TIMING_BATCH}, gamma^1/2 = 0.1; tile models {ERK_TIMING_STEPS} steps, a correct "
                              f"a step, nll_bwd every row without d/d gamma^1/2; HH {TEAM_HH_TIMING_STEPS} steps "
                              "from rest, nll_bwd on the experiment's optimized rows"),
                       timed_lanes_finite_min=min(e["timed_lanes_finite"] for e in entries.values()),
                       reps={"tile": ERK_TIMING_REPS, "hh": TEAM_HH_TIMING_REPS}, library_call="none",
                       ms_range=ranges,
                       paths_instantiations={e["name"]: {f: e[f] for f in ("ms", "bound_ms", "plain_ms")}
                                             for e in path_entries.values()},
                       per_instantiation=str((OUT / "team_instantiations.json").relative_to(ROOT)))


def team_phases(plain_procs: dict, ptxas: list) -> dict:
    """team_parity, lv_kv3_optimize, lv_kv3_evaluate, hh_rkf45_evaluate,
    hh_rkf45_optimize and team_timing; returns the entries of every team
    instantiation for the kernels line and the launches of each path."""
    entries = {}  # (kernel, model, tableau, L, dtype name) -> kernels-line entry
    for model, tab, L in team_chains():
        for kernel in ("nll_fwd", "nll_bwd"):
            for dtype in (torch.float32, torch.float64):
                e = team_entry(kernel, model, tab, L, dtype)
                ptx_model, n = ("hodgkin_huxley", int(model[2:])) if model in TEAM_HH else (model, TILE_N[model])
                spill = next((q for q in ptxas if (q["kernel"], q["model"], q["tableau"], q["n"], q["L"], q["dtype"])
                              == (kernel, ptx_model, tab, n, L, e["dtype"])), {})
                e.update(registers=spill.get("registers"), spill_stores=spill.get("spill_stores"), launches=0)
                entries[(kernel, e["model"], tab, L, e["dtype"])] = e

    team_parity_phase(plain_procs, entries)
    paths = {**lv_kv3_phases(plain_procs), **hh_rkf45_phases(plain_procs)}
    team_timing_phase(plain_procs, entries)
    for _, by_chain in paths.values():
        for key, count in by_chain.items():
            kernel, model, tab, _, L, dt = key
            if (kernel, model, tab, L, dt) in entries:
                entries[(kernel, model, tab, L, dt)]["launches"] += count
    (OUT / "team_instantiations.json").write_text(json.dumps(list(entries.values()), indent=1))
    return {"entries": list(entries.values()), "paths": {name: counts for name, (counts, _) in paths.items()}}


PLAIN_REF_GROUPS = PLAIN_REF_GROUPS + team_ref_groups()


# ---- probabilistic ODE solutions: run_ode_solver, run_filter, run_calibration ----
SOLUTION_SYSTEMS = ("lotkavolterra", "lorenz", "vanderpol", "lcao")
# Lorenz is chaotic: float32 and float64, or two devices, part within its
# horizon; held on its first 1000 steps (t <= 10), reported after
LORENZ_HELD_STEPS = 1000
# depth of the ode_solver phase: gt/lotkavolterra is 800,000 Dopri65 steps
# (h = 1e-4, tN 80) and noise_gt/lotkavolterra 200,000 Kvaerno3 steps, at
# 1.67 ms and 7.8 ms a step on the card (the solve runs eagerly; measured
# on one H100): hours at full depth, so both are cut to keep the phase
# within about 15 s (the solvers, the step and the state are the configs');
# the Dopri65 solve cut from 5,000 steps to 2,500 to make room for the mesh
# phases
ODE_GT_STEPS = 2_500
ODE_NOISE_STEPS = 500  # 1,000 before the mesh phases
EXT_FILTERS = {"DenseEKF": "EKF", "UKF": "UKF", "SqrtUKF": "UKF_SQRT", "GMMSqrtEKF": "GMM_EKF"}
GT_NPZ = ROOT / "ode_uncertainty_tpu_torch" / "data" / "gt_lotkavolterra.npz"
REF_THREADS = 2  # CPU threads of the float64 reference process
SOLUTION_DIR = OUT / "solution"


def ulp_moved(x: np.ndarray) -> np.ndarray:
    """Each element moved by one ulp up or down (signs from numpy seed 0)."""
    return np.nextafter(x, np.random.default_rng(0).choice([-np.inf, np.inf], x.shape))


def solution_jobs() -> dict:
    """key -> (entry point, experiment, overrides) of every solution run."""
    from ode_uncertainty_tpu_torch.utils.config import load_experiment as load

    def h_of(name):
        raw = load(name)
        return raw["t0"], raw["solver_builder"]["init_args"]["step_size"]

    t0, h = h_of("gt/lotkavolterra")
    jobs = {"ode_gt": ("ode", "gt/lotkavolterra", {"tN": t0 + ODE_GT_STEPS * h})}
    t0, h = h_of("noise_gt/lotkavolterra")
    # every step saved (the config saves every 100th): the noise check then
    # has 2 x 1,001 samples, so a missing or mis-scaled noise fails it
    noise = {"tN": t0 + ODE_NOISE_STEPS * h, "save_interval": 1}
    jobs["ode_noise"] = ("ode", "noise_gt/lotkavolterra", noise)
    jobs["ode_noise_clean"] = ("ode", "noise_gt/lotkavolterra", {**noise, "noise_var": 0.0})
    for system in SOLUTION_SYSTEMS:
        jobs[f"ekf_{system}"] = ("filter", f"ekf_trajectory/rkf45/{system}", {})
    lv = "ekf_trajectory/rkf45/lotkavolterra"
    x0_moved = str(ulp_moved(np.asarray(parse_literal(load(lv)["x0"]), np.float64)).tolist())
    for name, path in EXT_FILTERS.items():
        jobs[f"ext_{name}"] = ("filter", lv, {"filter_builder": {"class_path": path}})
        jobs[f"ext_{name}_ulp"] = ("filter", lv, {"filter_builder": {"class_path": path}, "x0": x0_moved})
    jobs["pf"] = ("filter", "pf_trajectory/rkf45/lotkavolterra", {})
    jobs["cal"] = ("cal", "calibration/rkf45/lotkavolterra", {"y_path": str(GT_NPZ)})
    jobs["cal_ulp"] = ("cal", "calibration/rkf45/lotkavolterra", {"y_path": str(SOLUTION_DIR / "gt_ulp.npz")})
    return jobs


# the CPU float64 references: every job but the card-only ones
CPU_JOBS = ("ode_gt", "ode_noise_clean", *[f"ekf_{s}" for s in SOLUTION_SYSTEMS],
            *[f"ext_{n}{u}" for n in EXT_FILTERS for u in ("", "_ulp")], "cal", "cal_ulp")


def run_solution(key: str, device: str, float64: bool) -> tuple:
    """Runs job ``key`` through its entry point: (outputs as numpy, wall s,
    solver steps)."""
    from ode_uncertainty_tpu_torch import run_calibration, run_filter, run_ode_solver

    entry, experiment, over = solution_jobs()[key]
    raw = load_experiment(experiment)
    out = SOLUTION_DIR / f"{key}_{device}_{'f64' if float64 else 'f32'}.npz"
    cfg = build_config(raw, {**over, "device": device, "float64": float64, "output": str(out)})
    mod = {"ode": run_ode_solver, "filter": run_filter, "cal": run_calibration}[entry]
    steps = int(np.ceil((cfg["tN"] - cfg.get("t0", 0.0)) / cfg["solver_builder"].h))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mod.run(cfg)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in res.items()}, wall, steps


def solution_references(out_dir: Path, keys: list) -> None:
    """The CPU float64 references ``keys`` (of CPU_JOBS, and ``c2_route``),
    each saved as ``<key>.npz`` in ``out_dir`` (with its wall seconds) once
    complete. Runs in a process of its own beside the card phases."""
    torch.set_num_threads(REF_THREADS)
    if "cal_ulp" in keys:
        with np.load(GT_NPZ) as z:
            np.savez(SOLUTION_DIR / "gt_ulp.npz", t=z["t"], x=ulp_moved(z["x"]))
    for key in keys:
        if key == "c2_route":
            arrays = c2_values_and_grads("cpu", held_only=True)
        else:
            res, wall, steps = run_solution(key, "cpu", True)
            arrays = {**res, "_wall_s": wall, "_steps": steps}
        tmp = out_dir / f"{key}.npz.tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
        tmp.replace(out_dir / f"{key}.npz")


# the processes of the solution references: the solution jobs, and c2_route's lanes beside them (on a slow
# host the phases waited for the two run one after the other)
SOLUTION_REF_GROUPS = (CPU_JOBS, ("c2_route",))


def start_solution_references() -> dict:
    """Starts a process for each of SOLUTION_REF_GROUPS: {key: (process, log path)}."""
    SOLUTION_DIR.mkdir(exist_ok=True)
    for stale in SOLUTION_DIR.glob("*"):
        stale.unlink()
    procs = {}
    for i, keys in enumerate(SOLUTION_REF_GROUPS):
        log_path = OUT / f"solution_references_{i}.log"
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--solution-references",
                                 str(SOLUTION_DIR), *keys], stdout=open(log_path, "w"), stderr=subprocess.STDOUT,
                                cwd=ROOT)
        procs.update(dict.fromkeys(keys, (proc, log_path)))
    return procs


def reference(procs: dict, key: str) -> dict:
    """The CPU reference of ``key``, waiting for the process that computes it."""
    path = SOLUTION_DIR / f"{key}.npz"
    proc, log_path = procs[key]
    while not path.exists():
        if proc.poll() is not None and not path.exists():
            raise AssertionError(f"the CPU reference process of {key} failed: " + log_path.read_text()[-4000:])
        time.sleep(0.5)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def rel_gap(got: np.ndarray, ref: np.ndarray, axis_from: int = 1) -> np.ndarray:
    """|got - ref| relative to |ref| elementwise, and relative to the largest
    |ref| of the same saved step where the element is 0 (per step: a
    trajectory's covariance grows by orders of magnitude)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    if ref.ndim > axis_from:
        largest = np.abs(ref).max(axis=tuple(range(axis_from, ref.ndim)), keepdims=True)
    else:
        largest = np.abs(ref).max()
    scale = np.where(ref != 0, np.abs(ref), largest)
    return np.where(diff == 0, 0.0, diff / np.where(scale > 0, scale, np.inf))


def step_scaled_gap(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """max |got - ref| of each saved step over the largest |ref| of that step."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    axes = tuple(range(1, ref.ndim))
    largest = np.abs(ref).max(axis=axes)
    return np.abs(got - ref).max(axis=axes) / np.where(largest > 0, largest, np.inf)


def solution_phases(refs: dict) -> None:
    """The ode_solver, filter_ekf, filter_pf, filter_ext and calibration
    phases (see the module note)."""
    with Phase("ode_solver") as ph:
        gt, gt_s, gt_steps = run_solution("ode_gt", "cuda", True)
        noisy, noise_s, noise_steps = run_solution("ode_noise", "cuda", True)
        ref_gt, ref_clean = reference(refs, "ode_gt"), reference(refs, "ode_noise_clean")
        x_gap = rel_gap(gt["x"], ref_gt["x"])
        if not (np.array_equal(gt["t"], ref_gt["t"]) or rel_gap(gt["t"], ref_gt["t"], 0).max() <= RTOL_F64) \
                or not x_gap.max() <= RTOL_F64:
            raise AssertionError(f"gt/lotkavolterra: card and CPU differ: x {x_gap.max()}")
        noise = (noisy["x"] - ref_clean["x"]).ravel()
        nv = load_experiment("noise_gt/lotkavolterra")["noise_var"]
        mean_se, var_se = np.sqrt(nv / noise.size), nv * np.sqrt(2.0 / (noise.size - 1))
        held = abs(noise.mean()) <= 5 * mean_se and abs(noise.var(ddof=1) - nv) <= 5 * var_se
        ph.info.update(
            gt={"steps": gt_steps, "cut_from": 800_000, "wall_s": gt_s, "s_per_step": gt_s / gt_steps,
                "x_max_rel_gap_vs_cpu_f64": float(x_gap.max()), "rtol": RTOL_F64,
                "eps_max_gap_rel_to_step_largest_reported": float(step_scaled_gap(gt["eps"], ref_gt["eps"]).max()),
                "cpu_wall_s": float(ref_gt["_wall_s"])},
            noise_gt={"steps": noise_steps, "cut_from": 200_000, "wall_s": noise_s, "s_per_step": noise_s / noise_steps,
                      "samples": int(noise.size), "noise_var": nv, "mean": float(noise.mean()), "mean_se": float(mean_se),
                      "var": float(noise.var(ddof=1)), "var_se": float(var_se), "held_5_se": bool(held),
                      "eps_max_gap_rel_to_step_largest_reported": float(step_scaled_gap(noisy["eps"], ref_clean["eps"]).max())})
        if not held:
            raise AssertionError(f"noise_gt/lotkavolterra noise statistics off: {ph.info['noise_gt']}")

    with Phase("filter_ekf") as ph:
        systems = {}
        for system in SOLUTION_SYSTEMS:
            key = f"ekf_{system}"
            r64, s64, steps = run_solution(key, "cuda", True)
            r32, s32, _ = run_solution(key, "cuda", False)
            ref = reference(refs, key)
            held = LORENZ_HELD_STEPS + 1 if system == "lorenz" else len(ref["t"])
            x_gap, p_gap = rel_gap(r64["x"], ref["x"]), step_scaled_gap(r64["P_sqrt"], ref["P_sqrt"])
            entry = {"steps": steps, "held_steps": held - 1, "s_per_step_f64": s64 / steps, "s_per_step_f32": s32 / steps,
                     "wall_s_f64": s64, "wall_s_f32": s32, "cpu_s_per_step_f64": float(ref["_wall_s"]) / steps,
                     "x_max_rel_gap_held": float(x_gap[:held].max()), "P_sqrt_max_gap_held": float(p_gap[:held].max()),
                     "x_max_rel_gap_after_reported": float(x_gap[held:].max(initial=0.0)),
                     "P_sqrt_max_gap_after_reported": float(p_gap[held:].max(initial=0.0)),
                     "f32_vs_f64_x_max_lane_err_reported": float(
                         (np.abs(r32["x"] - r64["x"]) / (np.abs(r64["x"]) + 1.0))[:held].max()),
                     "f32_vs_f64_P_sqrt_max_gap_reported": float(step_scaled_gap(r32["P_sqrt"], r64["P_sqrt"])[:held].max()),
                     "f32_finite": bool(np.isfinite(r32["x"]).all() and np.isfinite(r32["P_sqrt"]).all())}
            systems[system] = entry
            if not (entry["x_max_rel_gap_held"] <= RTOL_F64 and entry["P_sqrt_max_gap_held"] <= RTOL_F64):
                raise AssertionError(f"{system}: float64 card against float64 CPU off: {entry}")
            if not np.array_equal(r64["t"], ref["t"]):
                raise AssertionError(f"{system}: time grids differ")
        ph.info.update(rtol=RTOL_F64, systems=systems)

    with Phase("filter_pf") as ph:
        a, s_a, steps = run_solution("pf", "cuda", False)
        b, _, _ = run_solution("pf", "cuda", False)
        raw = load_experiment("pf_trajectory/rkf45/lotkavolterra")
        x0 = torch.tensor(parse_literal(raw["x0"]), dtype=torch.float32, device=DEVICE)
        det = solvers.solve(solvers.rkf45(raw["solver_builder"]["init_args"]["step_size"]), models.lotka_volterra(),
                            raw["t0"], x0, steps)
        p0_gap = rel_gap(a["x"][:, 0], det["x"].cpu().numpy())
        spread = a["x"][:, 1:].std(axis=1).max(axis=(-2, -1))
        checks = {"same_seed_same_ensemble": bool(np.array_equal(a["x"], b["x"])),
                  "all_finite": bool(np.isfinite(a["x"]).all()),
                  "particle0_vs_solve_max_rel_gap": float(p0_gap.max())}
        ph.info.update(particles=int(a["x"].shape[1]), steps=steps, dtype="float32", wall_s=s_a, s_per_step=s_a / steps,
                       rtol=RTOL_F64, spread_reported={"t": a["t"][::400].tolist(), "max_std": spread[::400].tolist()},
                       spread_grows=bool(spread[-1] > spread[1]), **checks)
        if not (checks["same_seed_same_ensemble"] and checks["all_finite"] and p0_gap.max() <= RTOL_F64):
            raise AssertionError(f"particle filter checks failed: {checks}")

    with Phase("filter_ext") as ph:
        filters = {}
        for name in EXT_FILTERS:
            got, wall, steps = run_solution(f"ext_{name}", "cuda", True)
            ref, probe = reference(refs, f"ext_{name}"), reference(refs, f"ext_{name}_ulp")
            entry = {"steps": steps, "wall_s": wall, "s_per_step": wall / steps,
                     "cpu_s_per_step": float(ref["_wall_s"]) / steps, "keys": {}}
            for key in sorted(k for k in ref if not k.startswith("_")):
                scaled = step_scaled_gap if ref[key].ndim > 1 else (lambda a, b: rel_gap(a, b, 0))
                # held at the limit; beside it (reported) the change that
                # moving x0 by one ulp makes on the CPU: the conditioning
                entry["keys"][key] = {"gap": float(scaled(got[key], ref[key]).max()),
                                      "one_ulp_x0_change_reported": float(scaled(probe[key], ref[key]).max())}
                if not entry["keys"][key]["gap"] <= RTOL_F64:
                    raise AssertionError(f"{name} {key}: float64 card against float64 CPU off: {entry['keys'][key]}")
            filters[name] = entry
        ph.info.update(experiment="ekf_trajectory/rkf45/lotkavolterra", rtol=RTOL_F64, filters=filters)

    with Phase("calibration") as ph:
        c64, s64, steps = run_solution("cal", "cuda", True)
        c32, s32, _ = run_solution("cal", "cuda", False)
        ref, probe = reference(refs, "cal"), reference(refs, "cal_ulp")
        levels = ref["noise_levels"]
        idx16 = np.linspace(0, levels.size - 1, 16).astype(int)
        lev_gap = rel_gap(c64["noise_levels"], levels, 0)
        out = {"levels": int(levels.size), "steps": steps, "wall_s_f64": s64, "wall_s_f32": s32,
               "s_per_step_f64": s64 / steps, "s_per_step_f32": s32 / steps,
               "cpu_s_per_step_f64": float(ref["_wall_s"]) / steps, "noise_levels_max_rel_gap": float(lev_gap.max())}
        ok = lev_gap.max() <= RTOL_F64
        for key in ("nll_conrad", "nll_ours"):
            scale = np.abs(np.atleast_1d(ref[key]))
            rel = np.atleast_1d(np.abs(c64[key] - ref[key])) / scale
            ok &= bool(rel.max() <= RTOL_F64)
            # reported beside it: the change that moving each observation by
            # one ulp makes on the CPU (the NLL's conditioning)
            out[key] = {"max_rel_gap": float(rel.max()),
                        "rel_gap_16_levels": rel[idx16 if key == "nll_conrad" else [0]].tolist(),
                        "max_rel_one_ulp_change_reported": float((np.atleast_1d(np.abs(probe[key] - ref[key])) / scale).max()),
                        "f32_vs_f64_max_rel_reported": float((np.abs(np.atleast_1d(c32[key] - c64[key])) / scale).max())}
        out["levels_16"] = levels[idx16].tolist()
        out["argmin_card_f64"], out["argmin_cpu_f64"] = int(np.argmin(c64["nll_conrad"])), int(np.argmin(ref["nll_conrad"]))
        out["argmin_card_f32_reported"] = int(np.argmin(c32["nll_conrad"]))
        out["nll_ours_f64"], out["best_static_nll_f64"] = float(c64["nll_ours"]), float(c64["nll_conrad"].min())
        ph.info.update(experiment="calibration/rkf45/lotkavolterra", ground_truth=str(GT_NPZ.relative_to(ROOT)),
                       rtol=RTOL_F64, **out)
        if not ok or out["argmin_card_f64"] != out["argmin_cpu_f64"]:
            raise AssertionError(f"calibration: card and CPU differ: {out}")


# ---- multi-compartment Hodgkin-Huxley through make_nll + autograd (no NLL kernel) ----
C2_EXPERIMENT = "params/hodgkinhuxley2_c2_r4"
C2_DATA = HH_DATA / "hodgkinhuxley_c2_r4.npz"
# The route runs eagerly: about 2.5 s a step forward and 4.7 s forward plus
# backward on the card, at 1 lane as at 100 (launch-bound;
# utils/autograd_probe.py on one H100), so the c2 phases run short horizons.
C2_T0 = 9.9  # the running sum t += h reaches the stimulus onset (t = 10) at step 11
# the script's 1,200 s limit sets these depths: the rig runs two steps past
# the onset, c2_optimize (one step) stops before it, the timings run 1
# step and the memory probes 2
C2_RIG_STEPS = 13
C2_POINTS = 4
C2_LANES = 100
C2_FD_STEP = 1e-5
C2_FD_TOL = 1e-4  # |autograd - differences| / (|differences| + 1)
C2_TIMING_STEPS = 1
# (1, 2) before the mesh phases: at 1 and 2 steps both probes held 97.97 MiB
C2_MEMORY_HORIZONS = (1,)
C2_OPT_STEPS = 1  # c2_optimize's horizon: the experiment's is 10^4 steps
C2_LBFGS_MAXITER = 2  # the experiment's is 200


def c2_lanes(spec, gammas) -> tuple:
    """([C2_LANES, P] normalized points, [C2_LANES] gamma^1/2) of c2_route:
    C2_POINTS points near the generating parameters, each at every stage's
    gamma^1/2 (point-major: the lanes held to the CPU), then each point at
    the first stage's gamma^1/2 moved by +C2_FD_STEP and -C2_FD_STEP in each
    normalized coordinate and then in gamma^1/2 (the central differences),
    then random points at the first stage's gamma^1/2 up to C2_LANES."""
    rng = np.random.default_rng(SEED + 13)
    dim = spec.num_opt
    base = np.clip(spec.defaults_norm_opt().cpu().numpy() + rng.uniform(-0.1, 0.1, (C2_POINTS, dim)), 0.0, 1.0)
    gs = np.sqrt(np.asarray(gammas, np.float64))
    shifts = np.repeat(np.eye(dim + 1), 2, axis=0) * np.tile([C2_FD_STEP, -C2_FD_STEP], dim + 1)[:, None]
    fd = (base[:, None, :] + shifts[None, :, :dim]).reshape(-1, dim)
    fd_g = (gs[0] + np.tile(shifts[:, dim], C2_POINTS))
    extra = C2_LANES - len(gs) * C2_POINTS - len(fd)
    p = np.concatenate([np.repeat(base, len(gs), axis=0), fd, rng.uniform(size=(extra, dim))])
    g = np.concatenate([np.tile(gs, C2_POINTS), fd_g, np.full(extra, gs[0])])
    return p, g


def c2_values_and_grads(device: str, held_only: bool = False) -> dict:
    """c2_route's NLLs and autograd gradients through the entry points'
    batched_nll (one forward and one backward, timed) on every lane of
    c2_lanes, or on the lanes held to the CPU alone."""
    rig, cfg = rig_at(C2_EXPERIMENT, C2_RIG_STEPS, torch.float64, device, t0=C2_T0)
    nll_b, on_kernels = rpe.batched_nll(rig, cfg, grad=True)
    gammas = gammas_of(cfg, torch.float64).cpu().numpy()
    p, g = c2_lanes(rig.spec, gammas)
    if held_only:
        held = len(gammas) * C2_POINTS
        p, g = p[:held], g[:held]
    q = torch.as_tensor(p, device=device).requires_grad_(True)
    gg = torch.as_tensor(g, device=device).requires_grad_(True)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    vals = nll_b(q, gg[:, None, None])
    sync()
    t1 = time.perf_counter()
    vals.sum().backward()
    sync()
    t2 = time.perf_counter()
    return {"nll": vals.detach().cpu().numpy(), "dp": q.grad.cpu().numpy(), "dg": gg.grad.cpu().numpy(),
            "gammas": gammas, "fwd_s": t1 - t0, "bwd_s": t2 - t1, "steps": rig.num_steps,
            "on_kernels": on_kernels}


def c2_phases(refs: dict) -> None:
    """The c2_route and c2_optimize phases (see the module note)."""
    with Phase("c2_route") as ph:
        nll_kernel.reset_launches()
        got = c2_values_and_grads(DEVICE)
        launches = dict(nll_kernel.launches)
        if got["on_kernels"] or any(launches.values()):
            raise AssertionError(f"c2_route took the kernels' route: {launches}")
        ref = reference(refs, "c2_route")
        held = len(ref["nll"])
        vals, grads = got["nll"], np.concatenate([got["dp"], got["dg"][:, None]], axis=1)
        ref_grads = np.concatenate([ref["dp"], ref["dg"][:, None]], axis=1)
        if not (np.isfinite(vals).all() and np.isfinite(grads).all() and np.isfinite(ref_grads).all()):
            raise AssertionError("c2_route: non-finite NLL or gradient")
        nll_rel = np.abs(vals[:held] - ref["nll"]) / np.abs(ref["nll"])
        diff = np.abs(grads[:held] - ref_grads)
        grad_rel = diff / np.where(ref_grads != 0, np.abs(ref_grads), np.abs(ref_grads).max())
        # central differences of the card's own forward at each point (first stage)
        stages, dim = len(ref["gammas"]), ref["dp"].shape[1]
        fd_vals = vals[held:held + C2_POINTS * 2 * (dim + 1)].reshape(C2_POINTS, dim + 1, 2)
        fd = (fd_vals[..., 0] - fd_vals[..., 1]) / (2.0 * C2_FD_STEP)
        at_points = grads[:held:stages]
        fd_err = np.abs(at_points - fd) / (np.abs(fd) + 1.0)
        checks = {"nll_max_rel_err_vs_cpu_f64": float(nll_rel.max()), "nll_rtol": RTOL_F64,
                  "grad_max_rel_err_vs_cpu_f64": float(grad_rel.max()), "grad_rtol": GRAD_RTOL_F64,
                  "grad_vs_central_differences_max_lane_err": float(fd_err.max()), "fd_tol": C2_FD_TOL}
        s = got["steps"]
        ph.info.update(experiment=C2_EXPERIMENT, observations=str(C2_DATA.relative_to(ROOT)), t0=C2_T0, steps=s,
                       lanes=len(vals), held_lanes=held, gammas=ref["gammas"].tolist(), fd_step=C2_FD_STEP,
                       route="make_nll + autograd", launches=launches, **checks,
                       nll_held=vals[:held].tolist(), grad_at_points=at_points.tolist(), central_differences=fd.tolist(),
                       cpu_f64_fwd_and_bwd_s=float(ref["fwd_s"] + ref["bwd_s"]), cpu_f64_lanes=held,
                       fwd_recording_s_per_step_100_lanes=got["fwd_s"] / s, bwd_s_per_step_100_lanes=got["bwd_s"] / s,
                       fwd_and_bwd_s_per_step_100_lanes=(got["fwd_s"] + got["bwd_s"]) / s)
        if not (nll_rel.max() <= RTOL_F64 and grad_rel.max() <= GRAD_RTOL_F64 and fd_err.max() <= C2_FD_TOL):
            raise AssertionError(f"c2_route: card and references differ: {checks}")

        # the eager route's time per step at 1 lane, and the forward
        # without autograd at 100 lanes, at a cut horizon
        gs0 = float(np.sqrt(ref["gammas"][0]))
        rig_t = rig_at(C2_EXPERIMENT, C2_TIMING_STEPS, torch.float64, DEVICE, t0=C2_T0)[0]
        one_lane = step_times(rig_t, 1, gs0, reps=1)
        p100 = probe_points(rig_t, C2_LANES)
        with torch.no_grad():
            _, fwd100 = synced(lambda: nll_of(rig_t)(p100, rig_t.q_sqrt, torch.tensor(gs0, device=DEVICE,
                                                                                       dtype=torch.float64)))
        memory = []
        for horizon in C2_MEMORY_HORIZONS:
            rig_h = rig_at(C2_EXPERIMENT, horizon, torch.float64, DEVICE, t0=C2_T0)[0]
            for label, kw in (("checkpoint per observation interval (remat)", {"remat": True}),
                              ("none (chunk_size=1)", {"chunk_size": 1})):
                memory.append({"steps": horizon, "lanes": C2_LANES, "checkpointing": label,
                               **peak_memory(rig_h, C2_LANES, gs0, **kw)})
        ph.info.update(timing_steps=C2_TIMING_STEPS, one_lane=one_lane, fwd_s_per_step_100_lanes=fwd100 / C2_TIMING_STEPS,
                       peak_memory_fwd_and_bwd=memory)

    c2_path = OUT / "c2_optimize.npz"
    for stale in OUT.glob("c2_optimize.npz*"):
        stale.unlink()
    with Phase("c2_optimize") as ph:
        raw = load_experiment(C2_EXPERIMENT)
        h = raw["solver_builder"]["init_args"]["step_size"]
        cfg = build_config(raw, {"device": DEVICE, "tN": raw["t0"] + (C2_OPT_STEPS - 0.5) * h, "y_path": str(C2_DATA),
                                 "output": str(c2_path), "lbfgs_maxiter": C2_LBFGS_MAXITER, "resume": False})
        starts: dict = {}
        stage_grid = rpe.run_stage_grid

        def recording_grid(out, p0, gammas, stage_fn, *args, **kwargs):
            def recorded(p_norm, gamma, unit_key=None):
                starts.setdefault(float(gamma), []).append(p_norm.detach().clone())
                return stage_fn(p_norm, gamma, unit_key=unit_key)
            return stage_grid(out, p0, gammas, recorded, *args, **kwargs)

        rpe.run_stage_grid = recording_grid
        try:
            nll_kernel.reset_launches()
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = optimize(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
            launches = dict(nll_kernel.launches)
        finally:
            rpe.run_stage_grid = stage_grid
        rig = build_rig(cfg, torch.float32, torch.device(DEVICE))
        n_opt = rig.spec.num_opt
        if res["nll_optims"].shape != (100, 4) or res["params_optims"].shape != (100, 4, n_opt) or n_opt != 4:
            raise AssertionError(f"c2 optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if res["route"] != "make_nll + autograd" or any(launches.values()):
            raise AssertionError(f"c2 optimize took another route: {res['route']}, {launches}")
        final_all = np.asarray(res["nll_optims"], np.float64)
        finite = np.isfinite(final_all[:, -1])
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of 100 c2 restarts end finite")
        # the objective optimize built, at every stage's starting points and
        # gamma^1/2 in one batch (one gamma^1/2 per lane)
        nll_b = rpe.batched_nll(rig, cfg, grad=True)[0]
        gams = res["gammas"].tolist()
        p_start = [torch.cat(starts[float(np.float32(gam))]).to(device=DEVICE, dtype=torch.float32) for gam in gams]
        g_start = torch.cat([torch.full((len(ps),), gam, dtype=torch.float32, device=DEVICE).sqrt()
                             for ps, gam in zip(p_start, gams)])
        with torch.no_grad():
            start_all = nll_b(torch.cat(p_start), g_start[:, None, None]).double().cpu().numpy()
        descent = []
        for stage, gam in enumerate(gams):
            start = start_all[stage * 100:(stage + 1) * 100]
            col = final_all[:, stage]
            best_start = float(np.min(np.where(np.isfinite(start), start, np.inf)))
            best_final = float(np.min(np.where(np.isfinite(col), col, np.inf)))
            descent.append({"stage": stage, "gamma": gam, "best_start_nll": best_start, "best_final_nll": best_final,
                            "finite_start": int(np.isfinite(start).sum()), "finite_final": int(np.isfinite(col).sum())})
            if not best_final <= best_start:
                raise AssertionError(f"c2 optimize did not descend at stage {stage}: {descent[-1]}")
        ph.info.update(experiment=C2_EXPERIMENT, route=res["route"], launches=launches, restarts=100, stages=4,
                       dtype="float32", steps=rig.num_steps, cut_from_steps=10_000, lbfgs_maxiter=C2_LBFGS_MAXITER,
                       optimized=list(rig.spec.opt_keys), optimize_wall_s=wall, peak_memory_mib=peak_mib,
                       finite_final=int(finite.sum()), descent=descent,
                       dispatches_per_stage=[u["dispatches"] for u in res["units"]],
                       widest_per_stage=[u["widest"] for u in res["units"]],
                       lanes_at_max_iter_per_stage=[u["lanes_at_max_iter"] for u in res["units"]],
                       seconds_per_stage=[u["seconds"] for u in res["units"]],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       nll_spread_final_stage=[float(np.nanmin(final_all[:, -1])), float(np.nanmax(final_all[:, -1]))],
                       output=str(c2_path.relative_to(ROOT)))


# ---- the device L-BFGS (optimizer_mode=device), the filter-free baseline and tRMSE ----
LV2_OBS = OUT / "lv2_observations.npz"  # synthesized by the observations phase
DEVICE_PARITY_RESTARTS = 8
# device_parity's horizon: its CPU side (the plain gradient, one thread)
# takes ~3 s a dispatch at 200 steps and ~300 s in all (its cpu_f64_s); the
# experiment's is 2000 steps
DEVICE_PARITY_STEPS = 200
DEVICE_PARITY_X_ATOL = 1e-8  # normalized box
BASELINE_EXPERIMENT = "params_baseline/lotkavolterra2"
# the experiment's lbfgs_maxiter is 200. The eager solve's value and
# gradient at 100 lanes and 2000 steps take ~10 s a dispatch on the card
# (this phase's optimize), and the first Armijo iteration from the random
# restarts backtracks many times (the unscaled steepest-descent step leaves
# the box), so even one iteration would take minutes: the full-width cell
# runs the initial evaluation alone (one value-and-gradient dispatch at 100
# lanes); the float64 parity run iterates to its end at 100 steps (at 200
# its card side made 54 dispatches in 46 s; at 100, 66 dispatches on the
# CPU, at 50, 378: the shorter horizon's landscape makes the Armijo search
# backtrack more)
BASELINE_LBFGS_MAXITER = 0
BASELINE_GRID_CHECK = 16
BASELINE_PARITY_RESTARTS = 8
BASELINE_PARITY_STEPS = 100
# evaluate's 2,500 grid points in one batch (the CLI's eval_batch; its
# default, 256, makes ten eager solves of 2000 steps, ~3.6 s each)
BASELINE_EVAL_BATCH = 2500
DEVICE_REF_DIR = OUT / "device_refs"


def cut_config(experiment: str, device: str, float64: bool, steps: int = None, **over):
    """``experiment`` on the synthesized LV observations, cut to ``steps``
    solver steps (None: the experiment's horizon)."""
    raw = load_experiment(experiment)
    if steps is not None:
        over["tN"] = raw["t0"] + (steps - 0.5) * raw["solver_builder"]["init_args"]["step_size"]
    return build_config(raw, {"y_path": str(LV2_OBS), "device": device, "float64": float64, **over})


def steps_of(cfg) -> int:
    return num_steps_of(cfg, cfg["solver_builder"])


def device_parity_run(device: str) -> dict:
    """device_parity's run: the device stage optimizer (make_stage_optimizer,
    what optimize's device mode runs) over the entry points' batched_nll on
    params/lotkavolterra2 cut to DEVICE_PARITY_STEPS steps, float64, from
    DEVICE_PARITY_RESTARTS restarts (numpy's default_rng) through the first
    tempering stage's gamma and 0."""
    cfg = cut_config("params/lotkavolterra2", device, True, DEVICE_PARITY_STEPS, num_tempering_stages=2)
    rig = build_rig(cfg, torch.float64, torch.device(device))
    nll_b, on_kernels = rpe.batched_nll(rig, cfg, grad=True)
    gammas = gammas_of(cfg, torch.float64)
    stage = make_stage_optimizer(nll_b, max_iter=cfg["lbfgs_maxiter"], tol=cfg.get("lbfgs_tol", 1e-4))
    p = torch.as_tensor(np.random.default_rng(SEED + 14).uniform(size=(DEVICE_PARITY_RESTARTS, rig.spec.num_opt)),
                        device=device)
    out = {field: [] for field in LBFGSResult._fields}
    t0 = time.perf_counter()
    for gamma in gammas:
        res = stage(p, gamma)
        for field in out:
            out[field].append(getattr(res, field).cpu().numpy())
        p = res.x
    return {**{k: np.stack(v, axis=1) for k, v in out.items()}, "gammas": gammas.cpu().numpy(),
            "wall_s": time.perf_counter() - t0, "steps": rig.num_steps, "on_kernels": on_kernels}


def baseline_grid(cfg, spec) -> np.ndarray:
    """evaluate's normalized grid of the baseline config (the CLI's order)."""
    axes = [np.linspace(0.0, 1.0, int(cfg["num_param_evals"].get(k, 1))) for k in spec.opt_keys]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(axes))


def baseline_checks(device: str) -> dict:
    """The baseline's float64 checks: the NLL at BASELINE_GRID_CHECK points of
    evaluate's grid at the full horizon, and lbfgs_box (the baseline CLI's
    optimizer) from BASELINE_PARITY_RESTARTS restarts (numpy's default_rng)
    on the rig cut to BASELINE_PARITY_STEPS steps."""
    dev = torch.device(device)
    cfg = cut_config(BASELINE_EXPERIMENT, device, True)
    spec, nll = rpeb.build_baseline(cfg, torch.float64, dev)
    grid = baseline_grid(cfg, spec)
    idx = np.linspace(0, len(grid) - 1, BASELINE_GRID_CHECK).astype(int)
    t0 = time.perf_counter()
    with torch.no_grad():
        grid_nll = nll(torch.as_tensor(grid[idx], device=dev)).cpu().numpy()
    t1 = time.perf_counter()
    cut_cfg = cut_config(BASELINE_EXPERIMENT, device, True, BASELINE_PARITY_STEPS)
    spec_c, nll_c = rpeb.build_baseline(cut_cfg, torch.float64, dev)
    p0 = np.random.default_rng(SEED + 15).uniform(size=(BASELINE_PARITY_RESTARTS, spec_c.num_opt))
    res = lbfgs_box(nll_c, torch.as_tensor(p0, device=dev), 0.0, 1.0, max_iter=cut_cfg["lbfgs_maxiter"],
                    tol=cut_cfg.get("lbfgs_tol", 1e-4))
    out = {field: getattr(res, field).cpu().numpy() for field in res._fields}
    return {**out, "grid_idx": idx, "grid_nll": grid_nll, "grid_s": t1 - t0, "optimize_s": time.perf_counter() - t1}


def device_references(out_dir: Path) -> None:
    """The CPU float64 runs of diag_nan_lanes' cut horizon, of device_parity
    and of the baseline's checks, each saved as ``<key>.npz`` in
    ``out_dir``; waits for the synthesized observations. Runs in a process
    of its own beside the card phases."""
    torch.set_num_threads(1)
    while not LV2_OBS.exists():
        time.sleep(0.5)
    for key, run in (("diag_nan_lanes", diag_cut_values), ("baseline", baseline_checks),
                     ("device_parity", device_parity_run)):
        tmp = out_dir / f"{key}.tmp.npz"
        np.savez(tmp, **run("cpu"))
        tmp.replace(out_dir / f"{key}.npz")


def start_device_references() -> subprocess.Popen:
    DEVICE_REF_DIR.mkdir(exist_ok=True)
    for stale in DEVICE_REF_DIR.glob("*"):
        stale.unlink()
    log = open(OUT / "device_references.log", "w")
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--device-references",
                             str(DEVICE_REF_DIR)], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)


def device_ref(proc: subprocess.Popen, key: str) -> dict:
    """The CPU reference ``key`` of the device reference process, waiting
    for it."""
    path = DEVICE_REF_DIR / f"{key}.npz"
    waited = time.perf_counter()
    while not path.exists():
        if proc.poll() is not None and not path.exists():
            raise AssertionError("the device reference process ended without " + key + ": "
                                 + (OUT / "device_references.log").read_text()[-4000:])
        time.sleep(0.5)
    with np.load(path) as z:
        return {**{k: z[k] for k in z.files}, "waited_s": time.perf_counter() - waited}


def same_optimizer_run(got: dict, ref: dict, label: str, x_atol: float = DEVICE_PARITY_X_ATOL) -> dict:
    """Card against CPU runs of one optimizer: iterations and evaluations
    equal in every lane, x within ``x_atol``, f at rtol 1e-9 (the non-finite
    lanes coincide); on a mismatch, the lanes that differ."""
    fin = np.isfinite(ref["f"])
    f_rel = np.abs(got["f"][fin] - ref["f"][fin]) / np.abs(ref["f"][fin])
    x_err = np.abs(got["x"] - ref["x"])
    stat = {"iters_equal": bool(np.array_equal(got["iters"], ref["iters"])),
            "n_fev_equal": bool(np.array_equal(got["n_fev"], ref["n_fev"])),
            "x_max_abs_err": float(np.nanmax(x_err)), "x_atol": x_atol,
            "f_max_rel_err": float(f_rel.max()) if f_rel.size else 0.0, "f_rtol": RTOL_F64,
            "nonfinite_mismatch": int((np.isfinite(got["f"]) != fin).sum())}
    ok = (stat["iters_equal"] and stat["n_fev_equal"] and stat["x_max_abs_err"] <= x_atol
          and stat["f_max_rel_err"] <= RTOL_F64 and not stat["nonfinite_mismatch"])
    if not ok:
        lanes = np.nonzero((got["iters"] != ref["iters"]) | (got["n_fev"] != ref["n_fev"]))
        raise AssertionError(f"{label}: card and CPU runs differ: {stat}; lanes {lanes}: "
                             f"card iters {got['iters'][lanes]}, n_fev {got['n_fev'][lanes]}, f {got['f'][lanes]}; "
                             f"CPU iters {ref['iters'][lanes]}, n_fev {ref['n_fev'][lanes]}, f {ref['f'][lanes]}")
    return stat


DEVICE_OPT_OUT = OUT / "lv2_optimize_device.npz"


def device_phases(dev_refs: subprocess.Popen, host: dict = None) -> dict:
    """The device_optimize, device_parity, baseline and trmse phases (see the
    module note); ``host`` is the optimize phase's best final NLL and
    optimum. Returns device_optimize's launch counts."""
    counts = device_optimize_phase(host)
    device_parity_phase(dev_refs)
    baseline_phase(dev_refs)
    trmse_phase()
    return counts


def device_optimize_phase(host: dict = None) -> dict:
    dev_path = DEVICE_OPT_OUT
    for stale in OUT.glob("lv2_optimize_device*"):
        stale.unlink()
    with Phase("device_optimize") as ph:
        cfg = cut_config("params/lotkavolterra2", DEVICE, False, output=str(dev_path), optimizer_mode="device",
                         resume=False)
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        with LaunchTimer() as timer:
            res = optimize(cfg)
        wall = time.perf_counter() - t0
        counts = dict(nll_kernel.launches)
        launch_s = timer.durations()
        final = np.asarray(res["nll_optims"][:, -1], np.float64)
        if res["nll_optims"].shape != (100, 4) or res["params_optims"].shape != (100, 4, 2):
            raise AssertionError(f"device optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if min(counts.values()) <= 0 or res["route"] != "nll_fwd + nll_bwd kernels" or res["optimizer_mode"] != "device":
            raise AssertionError(f"device optimize did not run both kernels: {counts}, {res['route']}")
        finite = np.isfinite(final)
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of 100 device-mode restarts end finite")
        # every dispatch is one nll_fwd and one nll_bwd launch, in order:
        # each stage's launches are the next 2 x its dispatches
        dispatches = [u["dispatches"] for u in res["units"]]
        if len(launch_s) != 2 * sum(dispatches) or counts != {"nll_fwd": sum(dispatches), "nll_bwd": sum(dispatches)}:
            raise AssertionError(f"device optimize launches {counts} for {dispatches} dispatches")
        bounds = np.cumsum([0, *dispatches]) * 2
        stage_kernel_s = [sum(sec for _, sec in launch_s[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
        best = int(np.argmin(np.where(finite, final, np.inf)))
        kernel_total = sum(sec for _, sec in launch_s)
        ph.info.update(launches=counts, route=res["route"], optimizer_mode=res["optimizer_mode"], optimize_wall_s=wall,
                       restarts=100, stages=4, dtype="float32", steps=steps_of(cfg), lbfgs_maxiter=cfg["lbfgs_maxiter"],
                       finite_final=int(finite.sum()), best_final_nll=float(final[best]),
                       best_optimum=res["params_optims"][best, -1].tolist(), host_optimize=host,
                       seconds_per_stage=[u["seconds"] for u in res["units"]], dispatches_per_stage=dispatches,
                       widest_per_stage=[u["widest"] for u in res["units"]],
                       lanes_at_max_iter_per_stage=[u["lanes_at_max_iter"] for u in res["units"]],
                       kernel_seconds_per_stage=stage_kernel_s,
                       kernel_share_per_stage=[k / u["seconds"] for k, u in zip(stage_kernel_s, res["units"])],
                       kernel_seconds=timer.seconds(), kernel_share=kernel_total / wall,
                       device_idle_share_at_most=1.0 - kernel_total / wall,
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       n_fev_median_per_stage=np.median(res["num_nll_evals"], axis=0).tolist(),
                       output=str(dev_path.relative_to(ROOT)))
    return counts


def device_parity_phase(dev_refs: subprocess.Popen) -> None:
    with Phase("device_parity") as ph:
        nll_kernel.reset_launches()
        got = device_parity_run(DEVICE)
        parity_counts = dict(nll_kernel.launches)
        if not got["on_kernels"] or min(parity_counts.values()) <= 0:
            raise AssertionError(f"device_parity did not run the kernels: {parity_counts}")
        ref = device_ref(dev_refs, "device_parity")
        first = gammas_of(cut_config("params/lotkavolterra2", "cpu", True), torch.float64)[0]
        if not np.array_equal(got["gammas"], ref["gammas"]) or got["gammas"][0] != first:
            raise AssertionError(f"device_parity's stages {got['gammas']} are not the first stage's gamma and 0")
        stat = same_optimizer_run(got, ref, "device_parity")
        ph.info.update(restarts=DEVICE_PARITY_RESTARTS, steps=int(got["steps"]), cut_from_steps=2000,
                       gammas=got["gammas"].tolist(), launches=parity_counts, **stat,
                       iters=got["iters"].tolist(), n_fev=got["n_fev"].tolist(), card_s=float(got["wall_s"]),
                       cpu_f64_s=float(ref["wall_s"]), cpu_waited_s=ref["waited_s"],
                       lbfgs_maxiter=200, converged=got["converged"].tolist())


def baseline_phase(dev_refs: subprocess.Popen) -> None:
    base_path = OUT / "baseline.npz"
    base_path.unlink(missing_ok=True)
    with Phase("baseline") as ph:
        nll_kernel.reset_launches()
        cfg = cut_config(BASELINE_EXPERIMENT, DEVICE, False, output=str(base_path),
                         lbfgs_maxiter=BASELINE_LBFGS_MAXITER, eval_batch=BASELINE_EVAL_BATCH)
        # at the cut depth optimize is the timed value-and-gradient dispatch
        # at 100 lanes (lbfgs_box's initial evaluation) and the iterations
        opt = rpeb.optimize(cfg)
        final = np.asarray(opt["nll_optims"], np.float64)
        finite = np.isfinite(final)
        if final.shape != (100,) or finite.mean() < 0.95:
            raise AssertionError(f"baseline optimize: shape {final.shape}, {finite.sum()} finite")
        if (opt["num_lbfgs_iters"] > BASELINE_LBFGS_MAXITER).any():
            raise AssertionError(f"baseline optimize ran past lbfgs_maxiter: {opt['num_lbfgs_iters'].max()}")
        ev = rpeb.evaluate(cfg)
        vals = ev["nll_evals"]
        if vals.shape != (1, 2500) or not np.isfinite(vals).all():
            raise AssertionError(f"baseline evaluate gave {vals.shape}, finite {np.isfinite(vals).all()}")
        # float64: card against the CPU
        got = baseline_checks(DEVICE)
        ref = device_ref(dev_refs, "baseline")
        grid_rel = np.abs(got["grid_nll"] - ref["grid_nll"]) / np.abs(ref["grid_nll"])
        if not grid_rel.max() <= RTOL_F64:
            raise AssertionError(f"baseline grid NLLs differ from the CPU: {grid_rel.max()}")
        stat = same_optimizer_run(got, ref, "baseline optimize")
        f32_err = np.abs(vals[0, got["grid_idx"]] - got["grid_nll"]) / (np.abs(got["grid_nll"]) + 1.0)
        if any(nll_kernel.launches.values()):
            raise AssertionError(f"the baseline launched an NLL kernel: {nll_kernel.launches}")
        best = int(np.argmin(np.where(finite, final, np.inf)))
        ph.info.update(experiment=BASELINE_EXPERIMENT, route="make_baseline_nll + autograd (eager solve, no kernel)",
                       restarts=100, steps=steps_of(cfg), dtype="float32", lbfgs_maxiter=BASELINE_LBFGS_MAXITER,
                       cut_from_lbfgs_maxiter=200, optimize_wall_s=float(opt["wall_clock_s"]),
                       value_and_grad_dispatches=int(opt["num_nll_evals"].max()), finite_final=int(finite.sum()),
                       best_final_nll=float(final[best]), best_optimum=opt["params_optims"][best].tolist(),
                       nll_median=float(np.nanmedian(final)),
                       iters_median=float(np.median(opt["num_lbfgs_iters"])),
                       n_fev_total=int(opt["num_nll_evals"].sum()),
                       evaluate_points=int(vals.shape[1]), evaluate_wall_s=ev["wall_s"],
                       evaluate_batch=BASELINE_EVAL_BATCH,
                       evaluate_argmin=ev["param_evals"][int(np.argmin(vals[0]))].tolist(),
                       grid_check_points=BASELINE_GRID_CHECK, grid_f64_max_rel_err_vs_cpu=float(grid_rel.max()),
                       grid_f32_vs_f64_max_lane_err_reported=float(f32_err.max()),
                       parity_restarts=BASELINE_PARITY_RESTARTS, parity_steps=BASELINE_PARITY_STEPS,
                       parity_iters=got["iters"].tolist(), parity_n_fev=got["n_fev"].tolist(), **stat,
                       card_f64_grid_s=float(got["grid_s"]), card_f64_optimize_s=float(got["optimize_s"]),
                       cpu_f64_grid_s=float(ref["grid_s"]), cpu_f64_optimize_s=float(ref["optimize_s"]),
                       cpu_waited_s=ref["waited_s"], output=str(base_path.relative_to(ROOT)))


def trmse_phase() -> None:
    dev_path = DEVICE_OPT_OUT
    with Phase("trmse") as ph:
        # compute_trmse appends to the file it reads: one copy per run
        runs = {}
        for device in (DEVICE, "cpu"):
            copy = OUT / f"lv2_optimize_device_trmse_{device}.npz"
            copy.write_bytes(dev_path.read_bytes())
            tcfg = cut_config("params/lotkavolterra2", device, True, parameter_estimates_input=str(copy))
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = compute_trmse.run(tcfg)
            runs[device] = (out, time.perf_counter() - t0)
        got, ref = runs[DEVICE][0], runs["cpu"][0]
        fin = np.isfinite(ref["trmse_values"])
        if not np.array_equal(np.isfinite(got["trmse_values"]), fin):
            raise AssertionError("tRMSE: the non-finite rows of card and CPU differ")
        rel = [np.abs(got[k] - ref[k]) / np.abs(ref[k])
               for k in ("trmse_mean", "trmse_std")] + [np.abs(got["trmse_values"][fin] - ref["trmse_values"][fin])
                                                        / np.abs(ref["trmse_values"][fin])]
        max_rel = float(max(np.max(r) for r in rel))
        if not max_rel <= RTOL_F64:
            raise AssertionError(f"tRMSE: card and CPU differ by {max_rel}")
        ph.info.update(rows=int(fin.size), steps=steps_of(tcfg), finite_rows=int(fin.sum()), max_rel_err_vs_cpu_f64=max_rel,
                       rtol=RTOL_F64, trmse_mean=float(got["trmse_mean"]), trmse_std=float(got["trmse_std"]),
                       card_f64_s=runs[DEVICE][1], cpu_f64_s=runs["cpu"][1], source=str(dev_path.relative_to(ROOT)))


# ---- restart sharding over devices (parallel/mesh.py) and the ported scripts ----
MESH_SHARDS = 4
MESH_DEVICE_GAMMAS = (1e-2, 0.0)  # mesh_device's stages (measure_scaling's first gamma, then 0)
MESH_DEVICE_MAX_ITER = 15  # 25 before the team phases
COMPARE_MAXITER = 15  # compare_optimizer's --maxiter (25 before the team phases)
DIAG_EXPERIMENT = "params/hodgkinhuxley11_full"
DIAG_RESULT = HH_DATA / "hodgkinhuxley11_full_result.npz"  # results/params/hodgkinhuxley11_full.h5 as npz
DIAG_CUT_STEPS = 20  # diag_nan_lanes' float64 card-against-CPU horizon (the experiment's: 10^4)


def diag_config(device: str, steps: int = None):
    over = {"device": device, "y_path": str(HH_DATA / "hodgkinhuxley_full.npz"),
            "parameter_estimates_input": str(DIAG_RESULT)}
    if steps is not None:
        over["tN"] = (steps - 0.5) * 0.01
    return build_config(load_experiment(DIAG_EXPERIMENT), over)


def diag_cut_values(device: str) -> dict:
    """diag_nan_lanes' float64 evaluator at DIAG_CUT_STEPS steps on every
    re-evaluated point at its stage's gamma (the kernel on the card, the
    plain version on the CPU)."""
    cfg = diag_config(device, DIAG_CUT_STEPS)
    cases = diag_nan_lanes.nan_cases(np.load(DIAG_RESULT))
    vals = diag_nan_lanes.evaluate(diag_nan_lanes.build_nll(cfg, torch.float64), cases)
    return {"lanes": np.array([c[0] for c in cases]), "values": vals}


def four_shards() -> list:
    """MESH_SHARDS shards: one per card where there are that many, else all
    on cuda:0 (each on a stream of its own)."""
    n = torch.cuda.device_count()
    return [torch.device(f"cuda:{k}") for k in range(MESH_SHARDS)] if n >= MESH_SHARDS else [torch.device("cuda:0")] * MESH_SHARDS


def mesh_label(mesh) -> dict:
    return {"shards": len(mesh), "devices": [str(d) for d in mesh.devices],
            "cards": [f"{d} {torch.cuda.get_device_name(d)}" for d in mesh.distinct]}


def host_stages(stage_fn, p0: np.ndarray, gammas) -> dict:
    """Every tempering stage of a host stage optimizer from p0, each from the
    previous stage's optima: x, f, iters, n_fev stacked [R, S, ...]."""
    x, outs = p0, []
    for gam in gammas:
        res = stage_fn(x, float(gam))
        outs.append(res)
        x = res.x
    return {field: np.stack([getattr(o, field) for o in outs], axis=1) for field in ("x", "f", "iters", "n_fev")}


def mesh_phases(dev_refs: subprocess.Popen) -> dict:
    """The mesh_host, mesh_device, mesh_landscape, measure_scaling,
    diag_nan_lanes and compare_optimizer phases (see the module note).
    Returns each phase's launch counts."""
    counts = {}
    cfg = cut_config("params/lotkavolterra2", DEVICE, False)
    gammas = gammas_of(cfg, torch.float32).cpu()
    spec = build_rig(cfg, torch.float32, torch.device(DEVICE)).spec
    p0 = rpe.initial_restarts(cfg, spec, torch.float32)
    q = torch.eye(2)
    max_iter, tol = cfg["lbfgs_maxiter"], cfg.get("lbfgs_tol", 1e-4)

    with Phase("mesh_host") as ph:
        # the unsharded host optimizer on the same restarts, then a mesh of
        # every visible card and a mesh of MESH_SHARDS shards
        plain_on = Objective(cfg)
        kern = plain_on(DEVICE)
        t0 = time.perf_counter()
        with LaunchTimer() as timer:
            plain_stage = make_stage_optimizer_host(None, q, nll_batched=lambda p, gs: kern(p, q, gs),
                                                    max_iter=max_iter, tol=tol, dtype=torch.float32, progress_every=0)
            ref = host_stages(lambda x, g: plain_stage(torch.as_tensor(x, device=DEVICE), g), p0.cpu().numpy(), gammas)
        plain = {"wall_s": time.perf_counter() - t0, "dispatches": len(plain_on.widths),
                 "kernel_share": sum(timer.seconds().values()) / (time.perf_counter() - t0)}
        runs = {}
        nll_kernel.reset_launches()
        for label, mesh in (("all_cards", device_mesh()), (f"{MESH_SHARDS}_shards", device_mesh(devices=four_shards()))):
            on = Objective(cfg)
            stage = make_stage_optimizer_host(on, q, max_iter=max_iter, tol=tol, dtype=torch.float32, mesh=mesh,
                                              progress_every=0)
            t0 = time.perf_counter()
            with LaunchTimer() as timer:
                got = host_stages(stage, p0.cpu().numpy(), gammas)
            wall = time.perf_counter() - t0
            same = {field: bool(np.array_equal(got[field], ref[field], equal_nan=got[field].dtype.kind == "f"))
                    for field in got}
            if not all(same.values()):
                lanes = np.nonzero((got["n_fev"] != ref["n_fev"]).any(axis=1) | (got["f"] != ref["f"]).any(axis=1))[0]
                raise AssertionError(f"mesh_host {label} differs from the unsharded host optimizer: {same}, "
                                     f"lanes {lanes.tolist()[:10]}")
            kernel_s = timer.seconds()
            runs[label] = {**mesh_label(mesh), "wall_s": wall, "shard_calls": len(on.widths),
                           "dispatches": len(on.widths) // len(mesh), "widest_shard": max(on.widths),
                           "kernel_seconds_summed": kernel_s, "kernel_share_summed": sum(kernel_s.values()) / wall,
                           "bit_equal_to_unsharded": same}
        counts["mesh_host"] = dict(nll_kernel.launches)
        if min(counts["mesh_host"].values()) <= 0:
            raise AssertionError(f"mesh_host launched no kernel: {counts['mesh_host']}")
        final = ref["f"][:, -1]
        ph.info.update(experiment="params/lotkavolterra2", restarts=len(p0), stages=len(gammas), steps=steps_of(cfg),
                       dtype="float32", lbfgs_maxiter=max_iter, unsharded=plain, meshes=runs,
                       launches=counts["mesh_host"], finite_final=int(np.isfinite(final).sum()),
                       best_final_nll=float(np.nanmin(final)))

    with Phase("mesh_device") as ph:
        on_plain, on_mesh = Objective(cfg), Objective(cfg)
        gam = torch.tensor(MESH_DEVICE_GAMMAS, dtype=torch.float32)
        kern = on_plain(DEVICE)
        p0_dev = p0.to(DEVICE)
        t0 = time.perf_counter()
        ref = make_tempered_estimator(lambda p, gs: kern(p, q, gs), spec, max_iter=MESH_DEVICE_MAX_ITER, tol=tol)(
            p0_dev, gam)
        plain_s = time.perf_counter() - t0
        mesh = device_mesh(devices=four_shards())
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        got = make_sharded_tempered_estimator(on_mesh, spec, q, mesh, max_iter=MESH_DEVICE_MAX_ITER, tol=tol)(p0, gam)
        wall = time.perf_counter() - t0
        counts["mesh_device"] = dict(nll_kernel.launches)
        x_err = float(np.nanmax(np.abs(got.params_optims - ref.params_optims)
                                / (spec.maxs_flat - spec.mins_flat)[spec.opt_indices].cpu().numpy()))
        counters = {f: bool(np.array_equal(getattr(got, f), getattr(ref, f))) for f in ("num_lbfgs_iters", "num_nll_evals")}
        if not all(counters.values()) or not x_err <= DEVICE_PARITY_X_ATOL:
            raise AssertionError(f"mesh_device differs from the unsharded estimator: {counters}, x {x_err}")
        if min(counts["mesh_device"].values()) <= 0:
            raise AssertionError(f"mesh_device launched no kernel: {counts['mesh_device']}")
        ph.info.update(**mesh_label(mesh), restarts=len(p0), gammas=list(MESH_DEVICE_GAMMAS),
                       max_iter=MESH_DEVICE_MAX_ITER, steps=steps_of(cfg), dtype="float32", counters_equal=counters,
                       x_max_abs_err_normalized=x_err, x_atol=DEVICE_PARITY_X_ATOL,
                       f_bit_equal=bool(np.array_equal(got.nll_optims, ref.nll_optims, equal_nan=True)), wall_s=wall,
                       unsharded_wall_s=plain_s, shard_calls=len(on_mesh.widths), unsharded_calls=len(on_plain.widths),
                       launches=counts["mesh_device"])

    with Phase("mesh_landscape") as ph:
        grid = torch.as_tensor(np.stack(np.meshgrid(*[np.linspace(0.0, 1.0, 20)] * 2, indexing="ij"), -1)
                               .reshape(-1, 2), dtype=torch.float32)
        on = Objective(cfg)
        kern = on(DEVICE)
        ref = make_nll_landscape(kern, q.to(DEVICE), batch_size=256)(grid.to(DEVICE), gammas).cpu()
        mesh = device_mesh(devices=four_shards())
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        got = make_sharded_nll_landscape(on, q, mesh)(grid, gammas)
        wall = time.perf_counter() - t0
        counts["mesh_landscape"] = dict(nll_kernel.launches)
        if got.shape != (4, 400) or not np.array_equal(got.numpy(), ref.numpy(), equal_nan=True):
            raise AssertionError(f"mesh_landscape differs from make_nll_landscape: {got.shape}, "
                                 f"{(got - ref).abs().max() if got.shape == ref.shape else None}")
        if counts["mesh_landscape"]["nll_fwd"] != 4 * MESH_SHARDS:
            raise AssertionError(f"mesh_landscape launches {counts['mesh_landscape']}")
        ph.info.update(**mesh_label(mesh), grid=400, stages=len(gammas), bit_equal=True, wall_s=wall,
                       launches=counts["mesh_landscape"])

    with Phase("measure_scaling") as ph:
        nll_kernel.reset_launches()
        rows = measure_scaling.main(["--path", "host", "--devices", "1,2,4", "--per-device", "16"])
        counts["measure_scaling"] = dict(nll_kernel.launches)
        for row in rows:
            if not (row["finite"] and np.isfinite([row["wall_s"], row["partition_overhead"]]).all() and row["cards"]):
                raise AssertionError(f"measure_scaling: {row}")
        ph.info.update(rows=rows, launches=counts["measure_scaling"])

    with Phase("diag_nan_lanes") as ph:
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        rows = diag_nan_lanes.run(diag_config(DEVICE))
        wall = time.perf_counter() - t0
        counts["diag_nan_lanes"] = dict(nll_kernel.launches)
        if not rows or counts["diag_nan_lanes"]["nll_fwd"] <= 0:
            raise AssertionError(f"diag_nan_lanes: {len(rows)} lanes, launches {counts['diag_nan_lanes']}")
        got = diag_cut_values(DEVICE)
        ref = device_ref(dev_refs, "diag_nan_lanes")
        held = np.array([np.isfinite(r["nll_f64"]) for r in rows])
        rel = np.abs(got["values"][held] - ref["values"][held]) / np.abs(ref["values"][held])
        if not np.array_equal(got["lanes"], ref["lanes"]) or not (rel.max(initial=0.0) <= RTOL_F64):
            raise AssertionError(f"diag_nan_lanes: card and CPU float64 differ at {DIAG_CUT_STEPS} steps: {rel}")
        ph.info.update(experiment=DIAG_EXPERIMENT, result=str(DIAG_RESULT.relative_to(ROOT)), lanes=rows,
                       launches=counts["diag_nan_lanes"], seconds_full_horizon=wall,
                       held_lanes=int(held.sum()), cut_steps=DIAG_CUT_STEPS,
                       f64_max_rel_err_vs_cpu_plain=float(rel.max(initial=0.0)), rtol=RTOL_F64,
                       cpu_waited_s=ref["waited_s"])

    with Phase("compare_optimizer") as ph:
        nll_kernel.reset_launches()
        out = compare_optimizer.main(["--experiment", "params/lotkavolterra2", "--restarts", "8",
                                      "--maxiter", str(COMPARE_MAXITER),
                                      "--set", f"y_path={LV2_OBS}"])
        counts["compare_optimizer"] = dict(nll_kernel.launches)
        rows = {r[0]: dict(zip(compare_optimizer.HEADER[1:], r[1:])) for r in out["rows"]}
        for name in ("host L-BFGS (ours)", "device L-BFGS (ours)"):
            if not np.isfinite(rows[name]["best_nll"]):
                raise AssertionError(f"compare_optimizer: {name} best NLL {rows[name]['best_nll']}")
        ph.info.update(device=out["device"], dtype="float64", restarts=8, maxiter=COMPARE_MAXITER,
                       stages=len(out["gammas"]),
                       rows=rows, launches=counts["compare_optimizer"])
    return counts


def main() -> int:
    if sys.argv[1:2] == ["--solution-references"]:
        solution_references(Path(sys.argv[2]), sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--plain-references"]:
        plain_references(Path(sys.argv[2]), sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--device-references"]:
        device_references(Path(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    global CARD
    t_start = time.perf_counter()
    OUT.mkdir(exist_ok=True)

    with Phase("device") as ph:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        ph.info.update(nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
                       device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    CARD = smi

    LV2_OBS.unlink(missing_ok=True)
    with Phase("observations") as ph:
        ph.info.update(synthesize_observations(LV2_OBS))

    # the LV plain references need no kernel: their processes run beside
    # the build; the CPU float64 references of the HH phases, of the
    # solution phases and of the device phases start after it
    plain_procs = start_plain_references(before_build=True)
    refs, dev_refs = {}, None
    try:
        with Phase("build") as ph:
            res = build_library()
            (OUT / "nvcc_ptxas.txt").write_text(res.log)
            ptxas = ptxas_report(res.log)
            ph.info.update(nvcc_seconds=res.seconds, built=res.built, library=str(res.path.relative_to(ROOT)),
                           units=len(list((ROOT / "ode_uncertainty_tpu_torch" / "csrc").glob("*.cu"))),
                           slowest_units_done_s=dict(sorted(res.unit_seconds.items(), key=lambda kv: -kv[1])[:8]),
                           ptxas=ptxas)
        refs = start_solution_references()
        plain_procs.update(start_plain_references(before_build=False))
        dev_refs = start_device_references()
        return run_phases(refs, plain_procs, dev_refs, t_start, ptxas)
    finally:
        for proc in ({p for p, _ in refs.values()} | {*plain_procs.values(), dev_refs}):
            if proc is None:
                continue
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def run_phases(refs: dict, plain_procs: dict, dev_refs: subprocess.Popen, t_start: float,
               ptxas: list) -> int:

    obs_path, out_path = LV2_OBS, OUT / "lv2_evaluate.npz"
    out_path.unlink(missing_ok=True)
    cfg = lv2_config(obs_path, out_path)
    grid_idx, axes, grid_norm, grid_gammas = lv2_grid(cfg)
    rigs = lv_parity_rigs(cfg)

    with Phase("parity") as ph:
        name, make, kw = rigs["parity_lv2"]
        lv2 = parity(name, make, plain_ref(plain_procs, "parity_lv2"), **kw)
        plain_grid = lv2.pop("_plain64")
        name, make, kw = rigs["parity_bench"]
        bench = parity(name, make, plain_ref(plain_procs, "parity_bench"), **kw)
        bench.pop("_plain64")
        ph.info.update(lotkavolterra2=lv2, bench_lv=bench,
                       plain_references="host CPU, processes of their own (PLAIN_REF_GROUPS)")

    with Phase("main_path") as ph:
        nll_kernel.reset_launches()
        res = evaluate(cfg)
        counts = dict(nll_kernel.launches)
        vals = res["nll_evals"]
        if vals.shape != (4, 400) or not np.isfinite(vals).all():
            raise AssertionError(f"evaluate gave shape {vals.shape}, finite {np.isfinite(vals).all()}")
        if counts["nll_fwd"] <= 0 or res["route"] != "nll_fwd kernel":
            raise AssertionError(f"main path did not run the kernel: {counts}, {res['route']}")
        # the grid lanes of the parity run: [random | grid] at 0.1, then at 0
        half = PARITY_LANES // 2
        ref = np.concatenate([plain_grid[half - GRID_CHECK:half].cpu().numpy(),
                              plain_grid[PARITY_LANES - GRID_CHECK:].cpu().numpy()])
        got = np.concatenate([vals[0, grid_idx], vals[-1, grid_idx]])
        err = np.abs(got - ref) / (np.abs(ref) + 1.0)
        if np.quantile(err, 0.99) > P99_F32:
            raise AssertionError(f"evaluate disagrees with the float64 plain version: {err.max()}")
        ph.info.update(launches=counts, route=res["route"], shape=list(vals.shape),
                       evaluate_wall_s=res["wall_s"], grid_p99_lane_err_vs_plain_f64=float(np.quantile(err, 0.99)),
                       nll_min=float(vals.min()), nll_max=float(vals.max()),
                       output=str(out_path.relative_to(ROOT)))
    eval_launches = counts["nll_fwd"]

    opt_path = OUT / "lv2_optimize.npz"
    for stale in OUT.glob("lv2_optimize.npz*"):
        stale.unlink()
    with Phase("optimize") as ph:
        opt_cfg = lv2_config(obs_path, opt_path)
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        with LaunchTimer() as timer:
            res = optimize(opt_cfg)
        wall = time.perf_counter() - t0
        opt_counts = dict(nll_kernel.launches)
        kernel_s = timer.seconds()
        final = np.asarray(res["nll_optims"][:, -1], np.float64)
        restarts, stages = res["nll_optims"].shape
        if (restarts, stages) != (100, 4) or res["params_optims"].shape != (100, 4, 2):
            raise AssertionError(f"optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if min(opt_counts.values()) <= 0 or res["route"] != "nll_fwd + nll_bwd kernels":
            raise AssertionError(f"optimize did not run both kernels: {opt_counts}, {res['route']}")
        finite = np.isfinite(final)
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of {restarts} restarts end finite")
        best = int(np.argmin(np.where(finite, final, np.inf)))
        # the NLL at the generating parameters, gamma = 0, by the same kernel
        kern = lv2_kernel(opt_cfg, torch.float32)
        truth = float(kern.launch(kern.physical(kern.spec.defaults_norm_opt()[None]), 0.0)[0])
        if not final[best] <= truth + 1e-3 * abs(truth):
            raise AssertionError(f"best final NLL {final[best]} above the generating parameters' {truth}")
        generating = kern.spec.defaults_flat[kern.spec.opt_indices].cpu().numpy()
        optimum = res["params_optims"][best, -1]
        rel = np.abs(optimum - generating) / generating
        if rel.max() > 0.10:
            raise AssertionError(f"best optimum {optimum} not within 10% of {generating}")
        ph.info.update(launches=opt_counts, route=res["route"], optimize_wall_s=wall,
                       restarts=restarts, stages=stages, finite_final=int(finite.sum()),
                       best_final_nll=float(final[best]), nll_at_generating_params=truth,
                       best_optimum=optimum.tolist(), generating=generating.tolist(),
                       optimum_rel_err=rel.tolist(), units=res["units"],
                       kernel_seconds=kernel_s, kernel_share=sum(kernel_s.values()) / wall,
                       device_idle_share_at_most=1.0 - sum(kernel_s.values()) / wall,
                       dispatches_per_stage=[u["dispatches"] for u in res["units"]],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       output=str(opt_path.relative_to(ROOT)))
    widest = max(u["widest"] for u in res["units"])
    opt_gamma_sqrt = float(np.sqrt(res["gammas"][0]))
    host_opt = {"best_final_nll": float(final[best]), "best_optimum": optimum.tolist(), "optimize_wall_s": wall,
                "dispatches_per_stage": [u["dispatches"] for u in res["units"]]}

    with Phase("kernel_timing") as ph:
        # one launch of the main path: the first grid batch (256 lanes) at stage 0
        kern = lv2_kernel(cfg, torch.float32)
        p = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)[:256],
                            dtype=torch.float32, device=DEVICE)
        phys = kern.physical(p)
        g = grid_gammas[0]
        kern.launch(phys, g)
        torch.cuda.synchronize()
        ms = event_times(lambda: kern.launch(phys, g), 7)
        # beside it: one lane (the first grid point)
        phys1 = phys[:, :1].contiguous()
        ms_b1 = event_times(lambda: kern.launch(phys1, g), 7)
        _, plain_ms = sync_time(lambda: nll_kernel.nll_plain(cut(kern.cm, PLAIN_TIMING_STEPS), phys, kern.ys, g))
        b_ms, b_by, ops = bound_ms(kern.cm, 256)
        fwd_line = {"name": "nll_fwd (explicit step, a thread per lane)", "route": "cuda",
                    "source": "ode_uncertainty_tpu_torch/csrc/nll_fwd.cu",
                    "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:722",
                    "launches": eval_launches + opt_counts["nll_fwd"],
                    "max_abs_err": lv2["kernel_f32_vs_plain_f64"]["max_abs_err"],
                    "ms": float(np.median(ms)), "plain_ms": plain_ms, "plain_steps": PLAIN_TIMING_STEPS,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        ph.info.update(shape=f"B=256, L={kern.cm.L}, d={kern.cm.d}, n_obs={kern.cm.n_obs}, float32",
                       event_ms=ms, ops=ops, launches_evaluate=eval_launches,
                       launches_optimize=opt_counts["nll_fwd"], event_ms_b1=ms_b1,
                       median_ms_b1=float(np.median(ms_b1)))

    with Phase("grad_timing") as ph:
        # one nll_bwd launch as optimize makes it: its widest dispatch, the
        # first stage's gamma, the optimized rows only (no d/d gamma)
        kern = lv2_kernel(cfg, torch.float32)
        p = torch.rand((widest, 2), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                       dtype=torch.float32, device=DEVICE)
        phys = kern.physical(p)
        g = torch.ones(widest, dtype=torch.float32, device=DEVICE)
        kern.grad.launch(phys, opt_gamma_sqrt, g, False, kern.opt_rows)
        torch.cuda.synchronize()
        ms = event_times(lambda: kern.grad.launch(phys, opt_gamma_sqrt, g, False, kern.opt_rows), 7)
        # beside it: every parameter row (the launch before the direction list),
        # and one lane
        ms_all_rows = event_times(lambda: kern.grad.launch(phys, opt_gamma_sqrt, g, False), 7)
        phys1, g1 = phys[:, :1].contiguous(), g[:1].contiguous()
        ms_b1 = event_times(lambda: kern.grad.launch(phys1, opt_gamma_sqrt, g1, False, kern.opt_rows), 7)
        _, plain_ms = sync_time(lambda: nll_kernel.nll_grad_plain(cut(kern.cm, PLAIN_TIMING_STEPS), phys, kern.ys,
                                                                   opt_gamma_sqrt, g))
        b_ms, b_by, ops = bound_ms(kern.cm, widest, grad=True)
        bwd_line = {"name": "nll_bwd (explicit step, a thread per lane and direction)", "route": "cuda",
                    "source": "ode_uncertainty_tpu_torch/csrc/nll_bwd.cu",
                    "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:851",
                    "launches": opt_counts["nll_bwd"],
                    "max_abs_err": None,  # grad_parity's, after throughput
                    "ms": float(np.median(ms)), "plain_ms": plain_ms, "plain_steps": PLAIN_TIMING_STEPS,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        # beside it: the same launch with d/d gamma^1/2 (one direction more),
        # and in float64
        ms_dgamma = event_times(lambda: kern.grad.launch(phys, opt_gamma_sqrt, g, True, kern.opt_rows), 7)
        k64 = lv2_kernel(cfg, torch.float64)
        phys64, g64 = k64.physical(p.double()), g.double()
        k64.grad.launch(phys64, opt_gamma_sqrt, g64, False, k64.opt_rows)
        ms64 = event_times(lambda: k64.grad.launch(phys64, opt_gamma_sqrt, g64, False, k64.opt_rows), 7)
        ms64_fwd = event_times(lambda: k64.launch(phys64, opt_gamma_sqrt), 7)
        ph.info.update(shape=f"B={widest}, {len(kern.opt_rows)} of K={kern.cm.k_params} directions, L={kern.cm.L}, "
                             f"d={kern.cm.d}, n_obs={kern.cm.n_obs}, float32, gamma^1/2={opt_gamma_sqrt:.6g}",
                       event_ms=ms, ops=ops, library_call="none", median_ms=float(np.median(ms)),
                       event_ms_all_rows=ms_all_rows, median_ms_all_rows=float(np.median(ms_all_rows)),
                       event_ms_with_dgamma=ms_dgamma, event_ms_float64=ms64, nll_fwd_event_ms_float64=ms64_fwd,
                       event_ms_b1=ms_b1, median_ms_b1=float(np.median(ms_b1)))

    with Phase("throughput") as ph:
        kern = bench_lv_kernel(torch.float32)
        p = torch.rand((8192, 2), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                       dtype=torch.float32, device=DEVICE)
        phys = kern.physical(p)
        g = float(np.sqrt(0.01))
        kern.launch(phys, g)
        torch.cuda.synchronize()
        ms = event_times(lambda: kern.launch(phys, g), 7)
        med = float(np.median(ms))
        _, plain_ms = sync_time(lambda: nll_kernel.nll_plain(cut(kern.cm, PLAIN_TIMING_STEPS),
                                                             phys[:, :1024].contiguous(), kern.ys, g))
        b_ms, b_by, ops = bound_ms(kern.cm, 8192)
        ph.info.update(workload="bench.py lv", batch=8192, steps=2000, obs_every=10, dtype="float32",
                       gamma=0.01, event_ms=ms, ms_per_launch=med,
                       filter_steps_per_s=8192 * 2000 / (med / 1e3),
                       plain_ms_b1024=plain_ms, plain_steps=PLAIN_TIMING_STEPS, bound_ms=b_ms, bound_by=b_by,
                       ops=ops)

    # after the LV phases: its float64 plain reference (~45 s of one core)
    # runs beside the build, which leaves it little of the host
    with Phase("grad_parity") as ph:
        lv2_grad, bench_grad = (grad_parity(rigs[key][0], rigs[key][1], plain_ref(plain_procs, key))
                                for key in ("grad_lv2", "grad_bench"))
        ph.info.update(lotkavolterra2=lv2_grad, bench_lv=bench_grad,
                       plain_references="host CPU, processes of their own (PLAIN_REF_GROUPS)")

    bwd_line["max_abs_err"] = lv2_grad["kernel_f32_vs_plain_f64"]["max_abs_err"]

    # ---- Hodgkin-Huxley evaluate through the Kvaerno3 nll_fwd ----
    hh_out = OUT / "hh_evaluate.npz"
    hh_out.unlink(missing_ok=True)
    hh_cfg = hh_config(out_path=hh_out)
    hh_full_cfg = hh_config(HH_FULL_EXPERIMENT, "hodgkinhuxley_full.npz")
    hh_gammas = gammas_of(hh_cfg, torch.float64)
    hh_gs0 = float(torch.sqrt(hh_gammas[0]))

    with Phase("hh_full_horizon") as ph:
        # the main path's rig at its full horizon: float32 kernel against the
        # float64 kernel on evaluate's grid at every stage (the plain version
        # would take hours), both on the step-index time rule (the tiles'),
        # where both types take the same edge steps; and the float64 gap
        # between that rule and the running sum, the rule of the entry points
        # (a float32 running sum switches the stimulus on a step earlier than
        # a float64 one)
        def full_kernel(dtype, accumulate_time=False):
            rig = build_rig(hh_cfg, dtype, torch.device(DEVICE))
            return nll_kernel.make_nll_cuda(rig.model, rig.solver, rig.ekf, rig.spec, rig.obs, rig.state0,
                                            rig.num_steps, rig.q_sqrt, accumulate_time=accumulate_time)

        k64, k32, k64_sum = full_kernel(torch.float64), full_kernel(torch.float32), full_kernel(torch.float64, True)
        grid = torch.linspace(0.0, 1.0, hh_cfg["num_param_evals"]["g_Na"], dtype=torch.float64, device=DEVICE)[:, None]
        runs = {"f64": [], "f32": [], "f64_sum": []}
        for g in hh_gammas.tolist():
            for label, kern in (("f64", k64), ("f32", k32), ("f64_sum", k64_sum)):
                runs[label].append(kern.launch(kern.physical(grid.to(kern.cm.dtype)), g ** 0.5))
        torch.cuda.synchronize()
        hh_v64, hh_v64_sum = torch.stack(runs["f64"]), torch.stack(runs["f64_sum"])
        gap = (hh_v64 - hh_v64_sum).abs()
        ph.info.update(steps=k64.cm.n_obs, lanes=grid.shape[0], stages=len(hh_gammas),
                       kernel_f32_vs_kernel_f64_step_index_rule=compare(torch.stack(runs["f32"]), hh_v64, False,
                                                                        HH_P99_F32),
                       tile_rule_vs_entry_point_rule_gap_f64_max_abs=gap.amax(dim=1).tolist(),
                       tile_rule_vs_entry_point_rule_gap_f64_max_rel=(gap / hh_v64.abs()).amax(dim=1).tolist(),
                       nll_f64_min=hh_v64.amin(dim=1).tolist(), nll_f64_entry_point_rule_min=hh_v64_sum.amin(dim=1).tolist())

    with Phase("hh_main_path") as ph:
        nll_kernel.reset_launches()
        res = evaluate(hh_cfg)
        hh_counts = dict(nll_kernel.launches)
        vals = res["nll_evals"]
        if vals.shape != (4, 100) or not np.isfinite(vals).all():
            raise AssertionError(f"evaluate gave shape {vals.shape}, finite {np.isfinite(vals).all()}")
        if hh_counts != {"nll_fwd": 4, "nll_bwd": 0} or res["route"] != "nll_fwd kernel":
            raise AssertionError(f"HH evaluate did not run the Kvaerno3 kernel 4 times: {hh_counts}, {res['route']}")
        # the wiring: 8 grid points equal a direct float32 launch with the
        # entry points' time rule, at the gamma^1/2 evaluate computes
        idx = np.linspace(0, vals.shape[1] - 1, HH_GRID_CHECK).astype(int)
        k32_sum = full_kernel(torch.float32, True)
        p_idx = torch.as_tensor(np.linspace(0.0, 1.0, vals.shape[1])[idx, None], dtype=torch.float32, device=DEVICE)
        direct = torch.stack([k32_sum.launch(k32_sum.physical(p_idx), float(torch.sqrt(gam)))
                              for gam in gammas_of(hh_cfg, torch.float32)]).cpu().numpy()
        if not np.array_equal(vals[:, idx], direct):
            raise AssertionError(f"HH evaluate differs from a direct launch: {vals[:, idx]} vs {direct}")
        # reported: their gap to the float64 kernel on the same rule (the
        # float32 running sum takes other edge steps than the float64 one)
        ref = hh_v64_sum[:, idx].cpu().numpy()
        err = np.abs(vals[:, idx] - ref) / (np.abs(ref) + 1.0)
        g_na = res["param_evals"][:, 0]
        best = float(g_na[int(np.argmin(vals[-1]))])
        if abs(best - HH_GNA_TRUE) > 0.10 * HH_GNA_TRUE:
            raise AssertionError(f"last stage's argmin g_Na {best} not within 10% of {HH_GNA_TRUE}")
        ph.info.update(launches=hh_counts, route=res["route"], shape=list(vals.shape), steps=k64.cm.n_obs,
                       evaluate_wall_s=res["wall_s"], grid_points_equal_direct_launch=True,
                       grid_points_vs_kernel_f64_max_lane_err_reported=float(err.max()),
                       argmin_g_na_last_stage=best, generating_g_na=HH_GNA_TRUE,
                       nll_min_per_stage=vals.min(axis=1).tolist(), output=str(hh_out.relative_to(ROOT)))

    # ---- Hodgkin-Huxley optimize through the Kvaerno3 nll_fwd and nll_bwd, before
    # the phases that read the HH plain references (their processes run meanwhile) ----
    hh_opt_path = OUT / "hh_optimize.npz"
    for stale in OUT.glob("hh_optimize.npz*"):
        stale.unlink()
    with Phase("hh_optimize") as ph:
        hh_opt_cfg = hh_config(out_path=hh_opt_path)
        hh_opt_cfg["lbfgs_maxiter"] = HH_LBFGS_MAXITER
        nll_kernel.reset_launches()
        t0 = time.perf_counter()
        with LaunchTimer() as timer:
            res = optimize(hh_opt_cfg)
        wall = time.perf_counter() - t0
        hh_opt_counts = dict(nll_kernel.launches)
        kernel_s = timer.seconds()
        final = np.asarray(res["nll_optims"][:, -1], np.float64)
        if res["nll_optims"].shape != (100, 4) or res["params_optims"].shape != (100, 4, 1):
            raise AssertionError(f"HH optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if min(hh_opt_counts.values()) <= 0 or res["route"] != "nll_fwd + nll_bwd kernels":
            raise AssertionError(f"HH optimize did not run both kernels: {hh_opt_counts}, {res['route']}")
        finite = np.isfinite(final)
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of 100 HH restarts end finite")
        best = int(np.argmin(np.where(finite, final, np.inf)))
        # the NLL at the generating parameters, gamma = 0, by the same kernel
        truth = float(k32_sum.launch(k32_sum.physical(k32_sum.spec.defaults_norm_opt()[None]), 0.0)[0])
        if not final[best] <= truth + 1e-3 * abs(truth):
            raise AssertionError(f"best final HH NLL {final[best]} above the generating parameters' {truth}")
        g_na_best = float(res["params_optims"][best, -1, 0])
        if abs(g_na_best - HH_GNA_TRUE) > 0.10 * HH_GNA_TRUE:
            raise AssertionError(f"best g_Na {g_na_best} not within 10% of {HH_GNA_TRUE}")
        ph.info.update(launches=hh_opt_counts, route=res["route"], optimize_wall_s=wall, restarts=100, stages=4,
                       steps=k64.cm.n_obs, lbfgs_maxiter=HH_LBFGS_MAXITER, finite_final=int(finite.sum()),
                       best_final_nll=float(final[best]), nll_at_generating_params=truth, best_g_na=g_na_best,
                       generating_g_na=HH_GNA_TRUE, units=res["units"],
                       kernel_seconds=kernel_s, kernel_share=sum(kernel_s.values()) / wall,
                       device_idle_share_at_most=1.0 - sum(kernel_s.values()) / wall,
                       dispatches_per_stage=[u["dispatches"] for u in res["units"]],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       output=str(hh_opt_path.relative_to(ROOT)))
    hh_widest = max(u["widest"] for u in res["units"])

    # ---- Hodgkin-Huxley full optimize through the n = 8 nll_fwd and nll_bwd ----
    hh_full_opt_path = OUT / "hh_full_optimize.npz"
    for stale in OUT.glob("hh_full_optimize.npz*"):
        stale.unlink()
    with Phase("hh_full_optimize") as ph:
        full_opt_cfg = hh_config(HH_FULL_EXPERIMENT, "hodgkinhuxley_full.npz", out_path=hh_full_opt_path)
        full_opt_cfg["lbfgs_maxiter"] = HH_FULL_LBFGS_MAXITER
        res, starts, full_opt_counts, _, wall, kernel_s = optimize_recording_starts(full_opt_cfg)
        n_opt = sum(full_opt_cfg["params_optimized"].values())
        if res["nll_optims"].shape != (100, 4) or res["params_optims"].shape != (100, 4, n_opt) or n_opt != 7:
            raise AssertionError(f"HH full optimize gave {res['nll_optims'].shape}, {res['params_optims'].shape}")
        if min(full_opt_counts.values()) <= 0 or res["route"] != "nll_fwd + nll_bwd kernels":
            raise AssertionError(f"HH full optimize did not run both kernels: {full_opt_counts}, {res['route']}")
        final_all = np.asarray(res["nll_optims"], np.float64)
        finite = np.isfinite(final_all[:, -1])
        if finite.mean() < 0.95:
            raise AssertionError(f"only {finite.sum()} of 100 HH full restarts end finite")
        # the wrapper optimize built (float32, the entry points' time rule) at
        # each stage's starting points and gamma^1/2, as the optimizer computes it
        kf = rpe.batched_nll(build_rig(full_opt_cfg, torch.float32, torch.device(DEVICE)), full_opt_cfg, grad=True)[0]
        descent = stage_descent(kf, res, starts)
        best = int(np.argmin(np.where(finite, final_all[:, -1], np.inf)))
        truth = float(kf.launch(kf.physical(kf.spec.defaults_norm_opt()[None].float()), 0.0)[0])
        generating = kf.spec.defaults_flat[kf.spec.opt_indices].cpu().numpy()
        optimum = res["params_optims"][best, -1]
        ph.info.update(launches=full_opt_counts, route=res["route"], optimize_wall_s=wall, restarts=100, stages=4,
                       steps=kf.cm.n_obs, optimized=list(kf.spec.opt_keys), lbfgs_maxiter=HH_FULL_LBFGS_MAXITER,
                       finite_final=int(finite.sum()), descent=descent,
                       best_final_nll=float(final_all[best, -1]), nll_at_generating_params_reported=truth,
                       best_optimum=optimum.tolist(), generating=generating.tolist(),
                       optimum_rel_err_reported=(np.abs(optimum - generating) / np.abs(generating)).tolist(),
                       units=res["units"], kernel_seconds=kernel_s, kernel_share=sum(kernel_s.values()) / wall,
                       device_idle_share_at_most=1.0 - sum(kernel_s.values()) / wall,
                       dispatches_per_stage=[u["dispatches"] for u in res["units"]],
                       iters_median_per_stage=np.median(res["num_lbfgs_iters"], axis=0).tolist(),
                       output=str(hh_full_opt_path.relative_to(ROOT)))
    full_widest = max(u["widest"] for u in res["units"])

    # ---- the Kvaerno3 nll_fwd against its plain version ----
    with Phase("hh_parity") as ph:
        spike_ref = plain_ref(plain_procs, "spike_x0")
        x_spike = spike_ref["x"]
        rigs = hh_parity_rigs(x_spike)
        hh_parities = {key[len("parity_"):]: hh_parity(rigs[key][0], rigs[key][1], hh_gs0, plain_ref(plain_procs, key),
                                                  **rigs[key][2])
                  for key in ("parity_onset_r4", "parity_onset_full", "parity_box_full", "parity_spike_r4")}
        onset_r4 = hh_parities["onset_r4"]
        ph.info.update(**hh_parities, spike_x0=x_spike.cpu().numpy().tolist(), spike_x0_solve_ms=spike_ref["ms"],
                       plain_references="host CPU, processes of their own (PLAIN_REF_GROUPS)")

    with Phase("hh_timing") as ph:
        timings = {}
        # evaluate's launch: B = 100 grid lanes, n = 4, 10^4 steps, stage 0
        for label, kern in (("f32", k32), ("f64", k64)):
            phys = kern.physical(grid.to(kern.cm.dtype))
            kern.launch(phys, hh_gs0)
            torch.cuda.synchronize()
            timings[f"evaluate_{label}_event_ms"] = event_times(lambda: kern.launch(phys, hh_gs0), 7)
        # optimize's widest dispatch: B = 256 lanes
        p256 = torch.rand((256, 1), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                          dtype=torch.float32, device=DEVICE)
        phys256 = k32.physical(p256)
        timings["b256_f32_event_ms"] = event_times(lambda: k32.launch(phys256, hh_gs0), 7)
        phys32 = k32.physical(grid.float())
        _, hh_plain_ms = sync_time(lambda: nll_kernel.nll_plain(cut(k32.cm, HH_PLAIN_TIMING_STEPS), phys32, k32.ys,
                                                                hh_gs0))
        hh_b_ms, hh_b_by, hh_ops = bound_ms(k32.cm, grid.shape[0], phys=phys32[:, :1])
        hh_ms = float(np.median(timings["evaluate_f32_event_ms"]))
        # bench.py's hh_full shape: B = 512, n = 8, 10^4 steps, gamma = 0.01
        kb = hh_bench_kernel(torch.float32)
        pb = torch.rand((512, kb.spec.num_opt), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                        dtype=torch.float32, device=DEVICE)
        physb = kb.physical(pb)
        gb = float(np.sqrt(0.01))
        outb = kb.launch(physb, gb)
        torch.cuda.synchronize()
        timings["hh_full_f32_event_ms"] = event_times(lambda: kb.launch(physb, gb), 7)
        medb = float(np.median(timings["hh_full_f32_event_ms"]))
        _, plain_b_ms = sync_time(lambda: nll_kernel.nll_plain(cut(kb.cm, HH_PLAIN_TIMING_STEPS), physb, kb.ys, gb))
        b_ms_b, b_by_b, ops_b = bound_ms(kb.cm, 512, phys=physb[:, :1])
        ph.info.update(
            evaluate_shape=f"B={grid.shape[0]}, n={k32.cm.n}, L=1, d=1, n_obs={k32.cm.n_obs}, gamma^1/2={hh_gs0:.6g}",
            evaluate_f32_ms=hh_ms, evaluate_f64_ms=float(np.median(timings["evaluate_f64_event_ms"])),
            b256_f32_ms=float(np.median(timings["b256_f32_event_ms"])),
            evaluate_filter_steps_per_s=grid.shape[0] * k32.cm.n_obs / (hh_ms / 1e3),
            evaluate_bound_ms=hh_b_ms, evaluate_bound_by=hh_b_by, evaluate_ops=hh_ops,
            evaluate_plain_ms=hh_plain_ms, plain_steps=HH_PLAIN_TIMING_STEPS,
            hh_full_shape=f"B=512, n={kb.cm.n}, K={kb.spec.num_opt} optimized, n_obs={kb.cm.n_obs}, float32, gamma=0.01",
            hh_full_ms=medb, hh_full_filter_steps_per_s=512 * kb.cm.n_obs / (medb / 1e3),
            hh_full_bound_ms=b_ms_b, hh_full_bound_by=b_by_b, hh_full_ops=ops_b, hh_full_plain_ms=plain_b_ms,
            hh_full_finite_lanes=int(torch.isfinite(outb).sum()), library_call="none", **timings)
        hh_line = {"name": "nll_fwd (Kvaerno3 step, a team of threads per lane)", "route": "cuda",
                   "source": "ode_uncertainty_tpu_torch/csrc/nll_fwd.cuh",
                   "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:722 (Kvaerno3 step, :291-364)",
                   "launches": hh_counts["nll_fwd"],
                   "max_abs_err": onset_r4["kernel_f32_vs_plain_f64"]["max_abs_err"],
                   "ms": hh_ms, "plain_ms": hh_plain_ms, "plain_steps": HH_PLAIN_TIMING_STEPS,
                   "bound_ms": hh_b_ms, "bound_by": hh_b_by, "library_ms": None}

    # ---- the Kvaerno3 nll_bwd against its plain version and central differences ----
    with Phase("hh_grad_parity") as ph:
        hh_grads = {key[len("grad_"):]: hh_grad_parity(rigs[key][0], rigs[key][1], hh_gs0, plain_ref(plain_procs, key),
                                                    **rigs[key][2])
                 for key in ("grad_onset_r4", "grad_spike_r4", "grad_onset_r1", "grad_onset_full", "grad_box_full")}
        onset = hh_grads["onset_r4"]
        ph.info.update(hh_grads)

    with Phase("hh_grad_full_horizon") as ph:
        # the main path's rig at its full horizon, 8 points of evaluate's
        # grid: the float64 gradient in g_Na against central differences of
        # the float64 forward kernel, and the float32 gradient against it
        idx8 = np.linspace(0, grid.shape[0] - 1, HH_GRID_CHECK).astype(int)
        p8 = grid[idx8]
        row = k64.opt_rows[0]
        ones = torch.ones(len(idx8), dtype=torch.float64, device=DEVICE)
        stages = []
        for stage, gam in enumerate(hh_gammas.tolist()):
            gsv = gam ** 0.5
            d64 = k64.grad.launch(k64.physical(p8), gsv, ones, False, k64.opt_rows)[0][row]
            d32 = k32.grad.launch(k32.physical(p8.float()), gsv, ones.float(), False, k32.opt_rows)[0][row]
            phys = k64.physical(p8)
            plus, minus = phys.clone(), phys.clone()
            plus[row] += HH_FD_REL_STEP * phys[row]
            minus[row] -= HH_FD_REL_STEP * phys[row]
            fd = (k64.launch(plus, gsv) - k64.launch(minus, gsv)) / (plus[row] - minus[row])
            torch.cuda.synchronize()
            fd_err = ((d64 - fd).abs() / (fd.abs() + 1.0)).cpu().numpy()
            k, r = d32.double().cpu().numpy(), d64.cpu().numpy()
            f32_err = np.abs(k - r) / (np.abs(r) + 1.0)
            entry = {"stage": stage, "gamma": gam, "grad_f64": r.tolist(), "grad_f32": k.tolist(),
                     "fd_max_lane_err": float(fd_err.max()), "fd_tol": HH_FD_TOL,
                     "f32_nonfinite": int((~np.isfinite(k)).sum()),
                     "f32_p99_lane_err": float(np.quantile(f32_err, 0.99)), "f32_max_lane_err": float(f32_err.max()),
                     "f32_held": stage in HH_GRAD_F32_HELD_STAGES}
            stages.append(entry)
            if not np.isfinite(r).all() or not fd_err.max() <= HH_FD_TOL:
                raise AssertionError(f"float64 nll_bwd disagrees with central differences of nll_fwd: {entry}")
            if not entry["f32_held"]:
                # the worst lane's gradients at neighbouring g_Na: float32
                # rounding, not the kernel, if the float32 ones scatter
                # while the float64 ones stay put
                lane = int(np.nanargmax(np.where(np.isfinite(f32_err), f32_err, np.inf)))
                near = p8[lane:lane + 1].repeat(8, 1)
                phys_near = k64.physical(near)
                phys_near[row] *= 1.0 + HH_F32_PROBE_REL * torch.arange(-4, 4, dtype=torch.float64, device=DEVICE)
                ones8 = torch.ones(8, dtype=torch.float64, device=DEVICE)
                entry["probe"] = {
                    "g_na": phys_near[row].tolist(),
                    "grad_f64": k64.grad.launch(phys_near, gsv, ones8, False, k64.opt_rows)[0][row].tolist(),
                    "grad_f32": k32.grad.launch(phys_near.float(), gsv, ones8.float(), False,
                                                k32.opt_rows)[0][row].tolist()}
            if entry["f32_held"] and not entry["f32_p99_lane_err"] <= HH_GRAD_P99_F32:
                raise AssertionError(f"float32 nll_bwd disagrees with the float64 kernel: {entry}")
        # HH full (n = 8) on params/hodgkinhuxley7_full at its 10^4 steps with
        # the entry points' time rule: g_Na at 0.8-1.2 times its generating
        # value (at 56 and 80 the float64 NLL itself diverges by gamma = 1e-8),
        # the other six optimized rows at their defaults, the float64 gradient
        # in g_Na; a lane whose NLL is not finite must have no finite gradient
        rig8 = build_rig(hh_full_cfg, torch.float64, torch.device(DEVICE))
        k8 = nll_kernel.make_nll_cuda(rig8.model, rig8.solver, rig8.ekf, rig8.spec, rig8.obs, rig8.state0,
                                      rig8.num_steps, rig8.q_sqrt, accumulate_time=True)
        row8 = k8.cm.offsets["g_Na"]
        phys8 = k8.physical(k8.spec.defaults_norm_opt()[None].repeat(4, 1))
        phys8[row8] *= torch.tensor([0.8, 0.9, 1.1, 1.2], dtype=torch.float64, device=DEVICE)
        ones4 = torch.ones(4, dtype=torch.float64, device=DEVICE)
        full_stages = []
        for stage, gam in enumerate(gammas_of(hh_full_cfg, torch.float64).tolist()):
            gsv = gam ** 0.5
            d8 = k8.grad.launch(phys8, gsv, ones4, False, (row8,))[0][row8]
            finite = torch.isfinite(k8.launch(phys8, gsv))
            plus, minus = phys8.clone(), phys8.clone()
            plus[row8] += HH_FD_REL_STEP * phys8[row8]
            minus[row8] -= HH_FD_REL_STEP * phys8[row8]
            fd = (k8.launch(plus, gsv) - k8.launch(minus, gsv)) / (plus[row8] - minus[row8])
            torch.cuda.synchronize()
            fd_err = ((d8 - fd).abs() / (fd.abs() + 1.0))[finite].cpu().numpy()
            entry = {"stage": stage, "gamma": gam, "grad_f64": d8.tolist(), "fd": fd.tolist(),
                     "finite_lanes": int(finite.sum()), "fd_max_lane_err": float(fd_err.max(initial=0.0)),
                     "fd_tol": HH_FD_TOL}
            full_stages.append(entry)
            if (not finite.any() or not torch.equal(torch.isfinite(d8), finite)
                    or not np.isfinite(fd_err).all() or not fd_err.max() <= HH_FD_TOL):
                raise AssertionError(f"n = 8 float64 nll_bwd disagrees with central differences of nll_fwd: {entry}")
        ph.info.update(steps=k64.cm.n_obs, lanes=len(idx8), g_na=k64.physical(p8)[row].tolist(),
                       fd_rel_step=HH_FD_REL_STEP, f32_p99_limit=HH_GRAD_P99_F32,
                       f32_held_stages=list(HH_GRAD_F32_HELD_STAGES), stages=stages,
                       hh_full={"experiment": HH_FULL_EXPERIMENT, "steps": k8.cm.n_obs, "time_rule": "running sum",
                                "g_na": phys8[row8].tolist(), "stages": full_stages})

    with Phase("hh_grad_timing") as ph:
        # one nll_bwd launch as optimize makes it: its widest dispatch at the
        # first stage's gamma, the optimized row only (no d/d gamma)
        p = torch.rand((hh_widest, 1), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                       dtype=torch.float32, device=DEVICE)
        phys32, g32 = k32.physical(p), torch.ones(hh_widest, dtype=torch.float32, device=DEVICE)
        launch = lambda: k32.grad.launch(phys32, hh_gs0, g32, False, k32.opt_rows)
        launch()
        torch.cuda.synchronize()
        ms = event_times(launch, 7)
        ms_dgamma = event_times(lambda: k32.grad.launch(phys32, hh_gs0, g32, True, k32.opt_rows), 7)
        phys64, g64 = k64.physical(p.double()), g32.double()
        ms64 = event_times(lambda: k64.grad.launch(phys64, hh_gs0, g64, False, k64.opt_rows), 7)
        ms64_dgamma = event_times(lambda: k64.grad.launch(phys64, hh_gs0, g64, True, k64.opt_rows), 7)
        _, plain_ms = sync_time(lambda: nll_kernel.nll_grad_plain(cut(k32.cm, HH_PLAIN_TIMING_STEPS), phys32,
                                                                   k32.ys, hh_gs0, g32, k32.opt_rows))
        b_ms, b_by, ops = bound_ms(k32.cm, hh_widest, grad=True)
        hh_bwd_line = {"name": "nll_bwd (Kvaerno3 step, a team of threads per lane and direction; HH n = 4, 7, 8)",
                       "route": "cuda", "source": "ode_uncertainty_tpu_torch/csrc/nll_bwd.cuh",
                       "replaces": "ode_uncertainty_tpu/ops/pallas_ekf.py:851 (Kvaerno3 step, stage-solve rule :301-332)",
                       "launches": hh_opt_counts["nll_bwd"] + full_opt_counts["nll_bwd"],
                       "launches_by_path": {"hh_optimize (n = 4)": hh_opt_counts["nll_bwd"],
                                            "hh_full_optimize (n = 8)": full_opt_counts["nll_bwd"]},
                       "max_abs_err": onset["kernel_f32_vs_plain_f64"]["max_abs_err"],
                       "ms": float(np.median(ms)), "plain_ms": plain_ms, "plain_steps": HH_PLAIN_TIMING_STEPS,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        ph.info.update(shape=f"B={hh_widest}, 1 direction (g_Na), n={k32.cm.n}, L=1, d=1, n_obs={k32.cm.n_obs}, "
                             f"float32, gamma^1/2={hh_gs0:.6g}",
                       event_ms=ms, ops=ops, library_call="none", event_ms_with_dgamma=ms_dgamma,
                       event_ms_float64=ms64, event_ms_float64_with_dgamma=ms64_dgamma, median_ms=float(np.median(ms)),
                       median_ms_with_dgamma=float(np.median(ms_dgamma)), median_ms_float64=float(np.median(ms64)),
                       median_ms_float64_with_dgamma=float(np.median(ms64_dgamma)))

        # the n = 8 gradient: hh_full_optimize's widest dispatch on its 7 rows
        # (float32, float64), and bench.py's hh_full shape (B = 512, 11 rows)
        def n8_timing(kern, batch, gsv):
            p = torch.rand((batch, kern.spec.num_opt), generator=torch.Generator(device=DEVICE).manual_seed(SEED),
                           dtype=torch.float32, device=DEVICE).to(kern.cm.dtype)
            phys, g = kern.physical(p), torch.ones(batch, dtype=kern.cm.dtype, device=DEVICE)
            launch = lambda: kern.grad.launch(phys, gsv, g, False, kern.opt_rows)
            launch()
            torch.cuda.synchronize()
            ms = event_times(launch, HH_FULL_TIMING_REPS)
            _, plain_ms = sync_time(lambda: nll_kernel.nll_grad_plain(cut(kern.cm, HH_N8_PLAIN_TIMING_STEPS), phys,
                                                                       kern.ys, gsv, g, kern.opt_rows))
            b_ms, b_by, ops = bound_ms(kern.cm, batch, grad=True)
            return {"shape": f"B={batch}, {len(kern.opt_rows)} directions, n={kern.cm.n}, L=1, d=1, "
                             f"n_obs={kern.cm.n_obs}, {str(kern.cm.dtype)[6:]}, gamma^1/2={gsv:.6g}",
                    "event_ms": ms, "ms": float(np.median(ms)), "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
                    "plain_ms": plain_ms, "plain_steps": HH_N8_PLAIN_TIMING_STEPS}

        # hh_full_optimize's wrapper (kf) and hh_grad_full_horizon's float64 one (k8)
        full_gs0 = float(torch.sqrt(gammas_of(hh_full_cfg, torch.float64)[0]))
        n8 = {"hh_full_optimize_widest_f32": n8_timing(kf, full_widest, full_gs0),
              "hh_full_optimize_widest_f64": n8_timing(k8, full_widest, full_gs0),
              "bench_hh_full_f32": n8_timing(hh_bench_kernel(torch.float32), 512, float(np.sqrt(0.01)))}
        ph.info.update(n8=n8, library_call_n8="none")
        hh_bwd_line["n8"] = {k: {f: v[f] for f in ("shape", "ms", "bound_ms", "bound_by", "plain_ms", "plain_steps")}
                             for k, v in n8.items()}

    # ---- the explicit-step kernels on every tile model and tableau, params/pendulum ----
    erk = erk_phases(plain_procs, ptxas)

    # ---- the team chains: Kvaerno3 on the tile models, HH under the explicit tableaus ----
    team = team_phases(plain_procs, ptxas)

    # ---- probabilistic ODE solutions (no NLL kernel on these paths) ----
    solution_phases(refs)

    # ---- multi-compartment HH through make_nll + autograd (no NLL kernel) ----
    c2_phases(refs)

    # ---- the device L-BFGS over the LV kernels, the baseline and tRMSE ----
    dev_counts = device_phases(dev_refs, host_opt)

    # ---- restart sharding and the ported scripts (rows 1 and 3; row 2 in diag_nan_lanes) ----
    mesh_counts = mesh_phases(dev_refs)

    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(CARD, flush=True)
    lv_mesh = ("mesh_host", "mesh_device", "mesh_landscape", "measure_scaling", "compare_optimizer")
    entry = lambda e: {k: e[k] for k in (*KERNEL_KEYS, "registers", "spill_stores")}
    # rows 1 and 3 (explicit steps) gain the HH paths, rows 2 and 4 (Kvaerno3) the LV one
    explicit_paths = {k: v for k, v in team["paths"].items() if k.startswith("hh_rkf45")}
    kvaerno3_paths = {k: v for k, v in team["paths"].items() if k.startswith("lv_kv3")}
    for line, name in ((fwd_line, "nll_fwd"), (bwd_line, "nll_bwd")):
        by_path = {"optimize (host L-BFGS)": opt_counts[name], "device_optimize (device L-BFGS)": dev_counts[name],
                   **{phase: mesh_counts[phase][name] for phase in lv_mesh},
                   **{phase: counts[name] for phase, counts in {**erk["paths"], **explicit_paths}.items()
                      if counts[name]}}
        if name == "nll_fwd":
            by_path = {"main_path (evaluate)": eval_launches, **by_path}
        # every other model and tableau: one entry an instantiation (erk_timing's and team_timing's times)
        line.update(launches=sum(by_path.values()), launches_by_path=by_path,
                    instantiations=[entry(e) for e in erk["entries"] + team["entries"]
                                    if e["name"].startswith(name) and e["tableau"] != "kvaerno3"])
    hh_by_path = {"hh_main_path (n = 4)": hh_counts["nll_fwd"], "hh_optimize (n = 4)": hh_opt_counts["nll_fwd"],
                  "hh_full_optimize (n = 8)": full_opt_counts["nll_fwd"],
                  "diag_nan_lanes (n = 8)": mesh_counts["diag_nan_lanes"]["nll_fwd"],
                  **{phase: counts["nll_fwd"] for phase, counts in kvaerno3_paths.items()}}
    hh_line.update(launches=sum(hh_by_path.values()), launches_by_path=hh_by_path)
    hh_bwd_line["launches_by_path"].update({phase: counts["nll_bwd"] for phase, counts in kvaerno3_paths.items()
                                            if counts["nll_bwd"]})
    hh_bwd_line["launches"] = sum(hh_bwd_line["launches_by_path"].values())
    # the Kvaerno3 step on the tile models: one entry an instantiation (team_timing's times)
    for line, name in ((hh_line, "nll_fwd"), (hh_bwd_line, "nll_bwd")):
        line["instantiations"] = [entry(e) for e in team["entries"]
                                  if e["name"].startswith(name) and e["tableau"] == "kvaerno3"]
    emit({"kernels": [fwd_line, hh_line, bwd_line, hh_bwd_line]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
