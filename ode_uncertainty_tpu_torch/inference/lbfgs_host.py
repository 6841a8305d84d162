"""Host-driven batched box L-BFGS (port of
``ode_uncertainty_tpu/inference/lbfgs_host.py``).

The division of labour is the reference's:

  device: one batched NLL + gradient dispatch per line-search trial (the
          NLL kernels and their autograd Function, or ``make_nll`` through
          autograd);
  host:   the O(R * P) bookkeeping (two-loop recursion over the history
          ring, projection, strong-Wolfe bracketing/zoom or the ladder
          search, convergence masks, bucket compaction, the stall stop) in
          numpy.

:func:`lbfgs_box_host` and its helpers are host numpy, kept identical in
behaviour to the reference (same iterates and counters on the same batched
objective; ``tests/test_torch_optimize.py`` holds them to it), except that
the loop does not yield to a benchmark: the reference checks its run lock
(``utils/runlock.py``) between iterations; the port has the module but its
loop does not call it. :func:`make_stage_optimizer_host` builds the batched
value-and-gradient dispatch in PyTorch, on one device or split over a mesh
of devices (``parallel/mesh.py``). The device L-BFGS is
``inference/lbfgs.py``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ode_uncertainty_tpu_torch.inference.lbfgs import value_and_grad


class HostLBFGSResult(NamedTuple):
    x: np.ndarray  # [R, P]
    f: np.ndarray  # [R]
    g: np.ndarray  # [R, P]
    iters: np.ndarray  # [R] int32
    n_fev: np.ndarray  # [R] int32
    converged: np.ndarray  # [R] bool


def _two_loop_batched(g, s_hist, y_hist, rho, head, count, m):
    """Vectorized two-loop recursion: g [R,P]; histories [m,R,P]; rho [m,R];
    head/count [R]. Returns the quasi-Newton direction -H g [R, P]."""
    r_idx = np.arange(g.shape[0])
    q = g.copy()
    alpha = np.zeros((m, g.shape[0]), g.dtype)
    for i in range(m):
        j = (head - 1 - i) % m  # [R]
        valid = i < count  # [R]
        s_j = s_hist[j, r_idx]  # [R, P]
        y_j = y_hist[j, r_idx]
        a = np.where(valid, rho[j, r_idx] * np.einsum("rp,rp->r", s_j, q), 0.0)
        q -= a[:, None] * y_j
        alpha[j, r_idx] = a

    j_last = (head - 1) % m
    y_l = y_hist[j_last, r_idx]
    s_l = s_hist[j_last, r_idx]
    denom = np.einsum("rp,rp->r", y_l, y_l)
    gamma = np.where(
        (count > 0) & (denom > 0.0), np.einsum("rp,rp->r", s_l, y_l) / np.where(denom > 0, denom, 1.0), 1.0
    )
    r = gamma[:, None] * q
    for i in range(m):
        j = (head - count + i) % m
        valid = i < count
        s_j = s_hist[j, r_idx]
        y_j = y_hist[j, r_idx]
        b = rho[j, r_idx] * np.einsum("rp,rp->r", y_j, r)
        r += np.where(valid, alpha[j, r_idx] - b, 0.0)[:, None] * s_j
    return -r


def _bucket(n: int, top: int, min_bucket: int = 16) -> int:
    """Smallest allowed dispatch width >= n: a power of two, capped at the
    full batch width ``top`` (which is always an allowed bucket — it is the
    shape of the first dispatch anyway)."""
    if n >= top:
        return top
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, top)


def _cubic_min(a_lo, f_lo, dg_lo, a_hi, f_hi, dg_hi):
    """Minimizer of the cubic interpolant on [a_lo, a_hi] (vectorized),
    safeguarded to the interior 10%-90% of the bracket; bisects when the
    interpolant is degenerate or any input is non-finite."""
    with np.errstate(all="ignore"):
        d1 = dg_lo + dg_hi - 3.0 * (f_lo - f_hi) / (a_lo - a_hi)
        rad = d1 * d1 - dg_lo * dg_hi
        d2 = np.sign(a_hi - a_lo) * np.sqrt(np.maximum(rad, 0.0))
        a_new = a_hi - (a_hi - a_lo) * (dg_hi + d2 - d1) / (dg_hi - dg_lo + 2.0 * d2)
    left = np.minimum(a_lo, a_hi)
    right = np.maximum(a_lo, a_hi)
    width = right - left
    mid = left + 0.5 * width
    bad = ~np.isfinite(a_new)
    a_new = np.where(bad, 0.5 * (a_lo + a_hi), a_new)
    # Safeguard: interior of the bracket, and at most halfway toward the
    # lo-side (in either bracket orientation), so repeated Armijo failures
    # shrink the bracket >= 2x per round (a 10%-interior clamp alone can
    # stall at 0.9x/round and never reach the tiny steps a cold
    # steepest-descent iteration needs).
    lo_is_left = a_lo <= a_hi
    floor = np.where(lo_is_left, left + 0.1 * width, np.maximum(left + 0.1 * width, mid))
    ceil = np.where(lo_is_left, np.minimum(right - 0.1 * width, mid), right - 0.1 * width)
    a_new = np.clip(a_new, floor, ceil)
    return a_new


def _sequential_wolfe(
    act, x, f, g, d, dg0, f_slack, n_fev,
    lower, upper, max_ls_rounds, wolfe_patience,
    armijo_c1, wolfe_c2, vg_rows,
    f_best, x_best, g_best, has_best,
    accepted, searching, x_acc, f_acc, g_acc,
):
    """Sequential batched strong-Wolfe search (bracket + cubic zoom,
    Nocedal-Wright Alg. 3.5/3.6): ONE trial alpha per lane per dispatch.
    Mutates ``n_fev`` and the best/accept carry arrays in place; returns
    ``(accepted, x_acc, f_acc, g_acc)`` over act-space. This is the
    ``ls_trials == 1`` path of :func:`lbfgs_box_host`; the ladder search
    there replaces it with batched multi-trial dispatches."""
    na = len(act)
    a_cur = np.ones(na)
    a_prev = np.zeros(na)
    f_prev = f[act].copy()
    dg_prev = dg0.copy()
    in_zoom = np.zeros(na, bool)
    a_lo = np.zeros(na)
    f_lo = f[act].copy()
    dg_lo = dg0.copy()
    a_hi = np.zeros(na)
    f_hi = np.zeros(na)
    dg_hi = np.zeros(na)

    for rd in range(max_ls_rounds):
        # Patience cut: near convergence the f32 slope noise can make
        # the curvature condition unsatisfiable — a lane that already
        # holds an Armijo-satisfying trial settles for it after a few
        # zoom rounds instead of burning max_ls_rounds dispatches
        # (the curvature-guarded history update already rejects
        # low-quality pairs).
        if rd >= wolfe_patience:
            searching[has_best] = False
        s = np.nonzero(searching)[0]
        if not len(s):
            break
        lanes = act[s]
        x_t = np.clip(x[lanes] + a_cur[s, None] * d[lanes], lower, upper)
        f_t, g_t = vg_rows(x_t)
        n_fev[lanes] += 1
        step = x_t - x[lanes]
        moved = np.max(np.abs(step), axis=-1) > 0.0
        # chord slopes along the *projected* path
        dg_t = np.einsum("rp,rp->r", g_t, step) / np.maximum(a_cur[s], 1e-300)
        gproj0 = np.einsum("rp,rp->r", g[lanes], step)
        finite = np.isfinite(f_t) & np.isfinite(g_t).all(axis=-1)
        armijo = (f_t <= f[lanes] + armijo_c1 * gproj0 + f_slack[lanes]) & moved & finite
        curv = np.abs(dg_t) <= wolfe_c2 * np.abs(dg0[s])
        acc_now = armijo & curv

        better = armijo & (f_t < f_best[s])
        bs = s[better]
        f_best[bs] = f_t[better]
        x_best[bs] = x_t[better]
        g_best[bs] = g_t[better]
        has_best[bs] = True

        ia = s[acc_now]
        accepted[ia] = True
        searching[ia] = False
        x_acc[ia] = x_t[acc_now]
        f_acc[ia] = f_t[acc_now]
        g_acc[ia] = g_t[acc_now]

        # --- update still-searching lanes -----------------------------
        rem_mask = ~acc_now
        rem = s[rem_mask]  # indices into act-space
        if not len(rem):
            continue
        rt = rem_mask  # mask over s-rows
        in_zoom_s = in_zoom[s].copy()  # zoom status BEFORE this round's updates
        was_zoom = in_zoom[rem].copy()

        # Bracketing phase (Alg 3.5): decide zoom entry or expand.
        br = rem[~was_zoom]
        brt = np.nonzero(rt & ~in_zoom_s)[0]  # rows of s for bracket lanes
        if len(br):
            f_tb = f_t[brt]
            dg_tb = dg_t[brt]
            a_b = a_cur[br]
            hi_entry = ~armijo[brt] | ((rd > 0) & (f_tb >= f_prev[br])) | ~finite[brt]
            pos_slope = ~hi_entry & (dg_tb >= 0.0)
            expand = ~hi_entry & ~pos_slope
            # zoom with (lo=prev, hi=cur)
            z1 = br[hi_entry]
            in_zoom[z1] = True
            a_lo[z1] = a_prev[z1]
            f_lo[z1] = f_prev[z1]
            dg_lo[z1] = dg_prev[z1]
            a_hi[z1] = a_b[hi_entry]
            f_hi[z1] = np.where(np.isfinite(f_tb[hi_entry]), f_tb[hi_entry], f_prev[z1])
            dg_hi[z1] = np.where(np.isfinite(dg_tb[hi_entry]), dg_tb[hi_entry], 0.0)
            # zoom with (lo=cur, hi=prev)
            z2 = br[pos_slope]
            in_zoom[z2] = True
            a_lo[z2] = a_b[pos_slope]
            f_lo[z2] = f_tb[pos_slope]
            dg_lo[z2] = dg_tb[pos_slope]
            a_hi[z2] = a_prev[z2]
            f_hi[z2] = f_prev[z2]
            dg_hi[z2] = dg_prev[z2]
            # expand
            e = br[expand]
            a_prev[e] = a_b[expand]
            f_prev[e] = f_tb[expand]
            dg_prev[e] = dg_tb[expand]
            a_cur[e] = np.minimum(a_b[expand] * 2.0, 64.0)

        # Zoom phase (Alg 3.6): shrink the bracket.
        zo = rem[was_zoom]
        zot = np.nonzero(rt & in_zoom_s)[0]
        if len(zo):
            f_tz = f_t[zot]
            dg_tz = dg_t[zot]
            a_z = a_cur[zo]
            to_hi = ~armijo[zot] | (f_tz >= f_lo[zo]) | ~finite[zot]
            # armijo holds, curvature failed: move lo (maybe flip hi)
            flip = ~to_hi & (dg_tz * (a_hi[zo] - a_lo[zo]) >= 0.0)
            fl = zo[flip]
            a_hi[fl] = a_lo[fl]
            f_hi[fl] = f_lo[fl]
            dg_hi[fl] = dg_lo[fl]
            lo_m = ~to_hi
            lz = zo[lo_m]
            a_lo[lz] = a_z[lo_m]
            f_lo[lz] = f_tz[lo_m]
            dg_lo[lz] = dg_tz[lo_m]
            hz = zo[to_hi]
            a_hi[hz] = a_z[to_hi]
            f_hi[hz] = np.where(np.isfinite(f_tz[to_hi]), f_tz[to_hi], f_hi[hz])
            dg_hi[hz] = np.where(np.isfinite(dg_tz[to_hi]), dg_tz[to_hi], 0.0)

        # next trial step for all zoom lanes (old and newly entered)
        zl = rem[in_zoom[rem]]
        if len(zl):
            a_cur[zl] = _cubic_min(
                a_lo[zl], f_lo[zl], dg_lo[zl], a_hi[zl], f_hi[zl], dg_hi[zl]
            )
            # degenerate bracket -> stop searching (fallback decides)
            tiny = np.abs(a_hi[zl] - a_lo[zl]) < 1e-12
            searching[zl[tiny]] = False

    # fallback: best Armijo trial for unaccepted lanes that found one
    fb = np.nonzero(~accepted & has_best)[0]
    accepted[fb] = True
    x_acc[fb] = x_best[fb]
    f_acc[fb] = f_best[fb]
    g_acc[fb] = g_best[fb]
    return accepted, x_acc, f_acc, g_acc


_STATE_KEYS = (
    "x", "f", "g", "iters", "n_fev", "s_hist", "y_hist", "rho",
    "head", "count", "stall", "done",
)


def _state_shapes(m: int, r: int, p: int) -> dict:
    """Expected array shape for every checkpointed state key."""
    return {
        "x": (r, p), "f": (r,), "g": (r, p), "iters": (r,), "n_fev": (r,),
        "s_hist": (m, r, p), "y_hist": (m, r, p), "rho": (m, r),
        "head": (r,), "count": (r,), "stall": (r,), "done": (r,),
    }


def _unit_fingerprint(x0: np.ndarray, token: str) -> str:
    """Hash of the unit's inputs (initial points + caller token such as the
    tempering gamma): a sidecar from a *different* unit input — stale file
    after a store reset, or a changed config — must not be restored."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(x0, np.float64)).tobytes())
    h.update(token.encode())
    return h.hexdigest()


def _save_iter_state(path: str, it: int, state: dict, fingerprint: str) -> None:
    """Atomically persists the full optimizer state at an iteration boundary
    (all host numpy; a few hundred KB at production sizes)."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, it=np.int64(it), fingerprint=np.array(fingerprint), **state)
    os.replace(tmp + ".npz", path)


def _load_iter_state(path: str, m: int, r: int, p: int, fingerprint: str):
    """Returns (start_iteration, state dict) from a sidecar written by
    ``_save_iter_state``, or None if absent, shape-mismatched (e.g. the
    history length ``m`` changed — mismatched ring buffers corrupt the
    two-loop recursion), or written for different unit inputs."""
    if not os.path.exists(path):
        return None
    try:
        shapes = _state_shapes(m, r, p)
        with np.load(path, allow_pickle=False) as z:
            # Legacy sidecars (pre-fingerprint) are accepted on a full shape
            # match so in-flight resumable stages survive the upgrade; any
            # *present* fingerprint must match exactly.
            if "fingerprint" in z and str(z["fingerprint"]) != fingerprint:
                return None
            if any(z[k].shape != shapes[k] for k in _STATE_KEYS):
                return None
            return int(z["it"]), {k: z[k].copy() for k in _STATE_KEYS}
    except Exception:
        return None


def lbfgs_box_host(
    value_and_grad_batched: Callable[[np.ndarray], tuple],
    x0: np.ndarray = None,
    lower: float = 0.0,
    upper: float = 1.0,
    max_iter: int = 200,
    history: int = 10,
    tol: float = 1e-6,
    max_ls_rounds: int = 20,
    wolfe_patience: int = 4,
    armijo_c1: float = 1e-4,
    wolfe_c2: float = 0.9,
    f32: bool = True,
    stall_iters: int = 5,
    compact: bool = True,
    ls_trials: int = 1,
    ls_width_cap: int = 256,
    progress: Callable[[int, np.ndarray], None] | None = None,
    state_path: str | None = None,
    state_token: str = "",
) -> HostLBFGSResult:
    """Minimizes a batched objective over the box [lower, upper]^P.

    Line search is batched **strong Wolfe** (bracket + cubic-interpolation
    zoom, Nocedal-Wright Alg. 3.5/3.6), matching the scipy L-BFGS-B search
    the reference's tempering was tuned against (the JAX package found
    Armijo-only backtracking to under-converge on LV2). Every trial
    evaluates value_and_grad in ONE dispatch, so the curvature condition
    costs nothing extra and accepted trials need no gradient refresh.

    Args:
        value_and_grad_batched: ``[B, P] -> (f [B], g [B, P])`` device call
            (any batch width B; widths are padded to power-of-2 buckets so
            at most log2(R) shapes ever occur).
        x0: [R, P] initial points.
        max_ls_rounds: vg trials per line search before falling back to the
            best Armijo-satisfying trial seen (or declaring failure).
        f32: objective dtype is float32 (sets the Armijo slack scale).
        stall_iters: stop a lane after this many consecutive accepted steps
            with below-slack objective progress (0 disables).
        compact: gather active lanes into power-of-2 dispatch buckets as
            lanes converge (see module docstring).
        ls_trials: candidate step sizes evaluated per lane per line-search
            dispatch. 1 selects the sequential bracket/zoom search; K > 1
            selects the ladder search (see module docstring), which bounds
            the line search at 4 dispatch rounds instead of
            ``max_ls_rounds``.
        ls_width_cap: max dispatch width for ladder trial blocks; trial
            matrices wider than ``max(ls_width_cap, R)`` are chunked into
            sequential dispatches of exactly that width (256 default, the
            reference's).
        progress: optional callback ``(iteration, done_mask)``.
        state_path: if set, the full optimizer state is persisted to this
            file at every iteration boundary and restored on entry, so a
            killed run resumes mid-stage instead of restarting the stage.  The sidecar is keyed
            by a fingerprint of (x0, state_token) and the full state shapes,
            so a stale file from a reset store / changed config / changed
            history length is discarded, never silently restored.  Deleted
            only when every lane is done (converged/stalled/failed) — a
            max_iter-bounded exit keeps it, so rerunning the unit with a
            higher limit continues instead of restarting.
        state_token: extra caller context mixed into the sidecar fingerprint
            (e.g. the tempering gamma of this stage).
    """
    x = np.clip(np.asarray(x0, np.float64), lower, upper)
    r, p = x.shape
    m = history
    eps_f = np.finfo(np.float32).eps if f32 else np.finfo(np.float64).eps
    fingerprint = _unit_fingerprint(x, state_token) if state_path else ""

    def vg_rows(rows):
        """value_and_grad on explicit rows, padded to a bucket width."""
        nr = len(rows)
        b = _bucket(nr, r) if compact else r
        if nr < b:
            rows = np.concatenate([rows, np.repeat(rows[:1], b - nr, axis=0)])
        fb, gb = value_and_grad_batched(rows)
        return np.asarray(fb, np.float64)[:nr], np.asarray(gb, np.float64)[:nr]

    def vg_rows_wide(rows):
        """value_and_grad on a trial matrix that can be wider than the lane
        batch (ladder search): chunks of at most ``max(ls_width_cap, R)``
        rows; chunks wider than the full batch pad to exactly the cap, so
        at most ONE shape beyond the compaction buckets ever occurs."""
        cap = max(ls_width_cap, r)
        fs, gs = [], []
        for i in range(0, len(rows), cap):
            chunk = rows[i : i + cap]
            nr = len(chunk)
            if nr > r:
                if nr < cap:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[:1], cap - nr, axis=0)]
                    )
                fb, gb = value_and_grad_batched(chunk)
                fs.append(np.asarray(fb, np.float64)[:nr])
                gs.append(np.asarray(gb, np.float64)[:nr])
            else:
                fb, gb = vg_rows(chunk)
                fs.append(fb)
                gs.append(gb)
        return np.concatenate(fs), np.concatenate(gs)

    def pg_norm(x_, g_):
        return np.max(np.abs(x_ - np.clip(x_ - g_, lower, upper)), axis=-1)

    it0 = 0
    loaded = _load_iter_state(state_path, m, r, p, fingerprint) if state_path else None
    if loaded is not None:
        it0, st = loaded
        x, f, g = st["x"], st["f"], st["g"]
        iters, n_fev = st["iters"], st["n_fev"]
        s_hist, y_hist, rho = st["s_hist"], st["y_hist"], st["rho"]
        head, count, stall, done = st["head"], st["count"], st["stall"], st["done"]
        print(
            f"    [lbfgs] resumed mid-stage at iter {it0} "
            f"({int((~done).sum())}/{r} lanes active)",
            flush=True,
        )
    else:
        f, g = vg_rows(x)
        # Flushed marker: the first dispatch may build the kernels.
        print(
            f"    [lbfgs] initial objective evaluated ({r} lanes, "
            f"median {np.nanmedian(f):.4g})",
            flush=True,
        )
        n_fev = np.ones(r, np.int32)
        iters = np.zeros(r, np.int32)
        s_hist = np.zeros((m, r, p))
        y_hist = np.zeros((m, r, p))
        rho = np.zeros((m, r))
        head = np.zeros(r, np.int64)
        count = np.zeros(r, np.int64)
        stall = np.zeros(r, np.int32)
        done = pg_norm(x, g) <= tol

    r_idx = np.arange(r)

    for it in range(it0, max_iter):
        if done.all():
            break
        act = np.nonzero(~done)[0]
        d = _two_loop_batched(g, s_hist, y_hist, rho, head, count, m)
        descent = np.einsum("rp,rp->r", g, d) < 0.0
        d = np.where(descent[:, None], d, -g)
        # Cold lanes (no curvature history) take raw steepest descent whose
        # magnitude can be ~1e5 x the box width — normalize so the unit
        # trial is O(box) and the Wolfe bracket starts in a sane range
        # (scipy L-BFGS-B similarly scales its first step by 1/||g||).
        gnorm = np.linalg.norm(d, axis=-1)
        cold = (count == 0) & (gnorm > 1.0)
        d = np.where(cold[:, None], d / np.maximum(gnorm, 1e-300)[:, None], d)
        f_slack = 16.0 * eps_f * np.maximum(np.abs(f), 1.0)

        na = len(act)
        dg0 = np.einsum("rp,rp->r", g[act], d[act])  # phi'(0), unprojected
        # best Armijo-satisfying trial so far (fallback on round exhaustion)
        f_best = np.full(na, np.inf)
        x_best = x[act].copy()
        g_best = g[act].copy()
        has_best = np.zeros(na, bool)
        accepted = np.zeros(na, bool)
        searching = np.ones(na, bool)
        x_acc = x[act].copy()
        f_acc = f[act].copy()
        g_acc = g[act].copy()

        if ls_trials > 1:
            # --- ladder strong-Wolfe search (K trials per dispatch) --------
            # Round 0 trials only the unit step (the warm-lane fast path:
            # one dispatch, exactly like the sequential search). Round 1
            # spans alpha in [1e-3, 4] geometrically; rounds 2-3 continue
            # the descent by 10^-K/2 per round for lanes that have not
            # found an Armijo point anywhere yet.
            K = int(ls_trials)
            # Down-candidates first (a too-big step is the common rejection),
            # two expansion candidates, then the deeper descent — so small K
            # still covers the important region. Duplicate-free and ordered
            # only for truncation: all K are evaluated simultaneously.
            base = [10 ** -0.5, 0.1, 4.0, 2.0, 10 ** -1.5, 0.01, 10 ** -2.5, 1e-3]
            if K > 8:
                base += [10 ** (-0.5 * i) for i in range(7, K + 3)]
            r1_grid = np.array(base[:K])
            dn_grid = 10.0 ** (-0.5 * np.arange(1, K + 1))
            lo_alpha = np.ones(na)
            for rd in range(4):
                s = np.nonzero(searching)[0]
                if not len(s):
                    break
                lanes = act[s]
                if rd == 0:
                    alphas = np.ones((len(s), 1))
                elif rd == 1:
                    alphas = np.broadcast_to(r1_grid, (len(s), K)).copy()
                else:
                    alphas = lo_alpha[s][:, None] * dn_grid[None, :]
                nk = alphas.shape[1]
                x_t = np.clip(
                    x[lanes][:, None, :] + alphas[..., None] * d[lanes][:, None, :],
                    lower,
                    upper,
                )
                f_t, g_t = vg_rows_wide(x_t.reshape(-1, p))
                f_t = f_t.reshape(len(s), nk)
                g_t = g_t.reshape(len(s), nk, p)
                n_fev[lanes] += nk
                step = x_t - x[lanes][:, None, :]
                moved = np.max(np.abs(step), axis=-1) > 0.0
                # chord slopes along the *projected* path
                dg_t = np.einsum("skp,skp->sk", g_t, step) / np.maximum(alphas, 1e-300)
                gproj0 = np.einsum("sp,skp->sk", g[lanes], step)
                finite = np.isfinite(f_t) & np.isfinite(g_t).all(axis=-1)
                armijo = (
                    f_t <= f[lanes][:, None] + armijo_c1 * gproj0 + f_slack[lanes][:, None]
                ) & moved & finite
                curv = np.abs(dg_t) <= wolfe_c2 * np.abs(dg0[s])[:, None]
                wolfe = armijo & curv
                rows = np.arange(len(s))
                # carry the best Armijo candidate across rounds
                f_arm = np.where(armijo, f_t, np.inf)
                k_arm = np.argmin(f_arm, axis=1)
                better = armijo.any(axis=1) & (f_arm[rows, k_arm] < f_best[s])
                bs = s[better]
                f_best[bs] = f_arm[rows[better], k_arm[better]]
                x_best[bs] = x_t[rows[better], k_arm[better]]
                g_best[bs] = g_t[rows[better], k_arm[better]]
                has_best[bs] = True
                # accept the lowest-f strong-Wolfe candidate now
                f_w = np.where(wolfe, f_t, np.inf)
                k_w = np.argmin(f_w, axis=1)
                acc_w = wolfe.any(axis=1)
                ia = s[acc_w]
                accepted[ia] = True
                searching[ia] = False
                x_acc[ia] = x_t[rows[acc_w], k_w[acc_w]]
                f_acc[ia] = f_t[rows[acc_w], k_w[acc_w]]
                g_acc[ia] = g_t[rows[acc_w], k_w[acc_w]]
                # From round 1 on, a lane holding an Armijo point settles
                # for it: the round-1 grid spans 3.6 decades — curvature
                # matching nowhere there means refinement would chase f32
                # slope noise (the sy-guarded history update rejects
                # low-quality pairs anyway). Rounds 2-3 serve only lanes
                # with no Armijo point at all.
                if rd >= 1:
                    settle = np.nonzero(searching & has_best)[0]
                    accepted[settle] = True
                    searching[settle] = False
                    x_acc[settle] = x_best[settle]
                    f_acc[settle] = f_best[settle]
                    g_acc[settle] = g_best[settle]
                lo_alpha[s] = np.minimum(lo_alpha[s], alphas.min(axis=1))
        else:
            accepted, x_acc, f_acc, g_acc = _sequential_wolfe(
                act, x, f, g, d, dg0, f_slack, n_fev,
                lower, upper, max_ls_rounds, wolfe_patience,
                armijo_c1, wolfe_c2, vg_rows,
                f_best, x_best, g_best, has_best,
                accepted, searching, x_acc, f_acc, g_acc,
            )

        ok = np.zeros(r, bool)
        x_new = x.copy()
        f_new = f.copy()
        g_new = g.copy()
        ia_full = act[accepted]
        ok[ia_full] = True
        x_new[ia_full] = x_acc[accepted]
        f_new[ia_full] = f_acc[accepted]
        g_new[ia_full] = g_acc[accepted]

        moved_lanes = ok & ~done

        # --- history update (curvature guard; reset-on-failure) -----------
        s_vec = x_new - x
        y_vec = g_new - g
        sy = np.einsum("rp,rp->r", s_vec, y_vec)
        good = moved_lanes & (
            sy > 1e-10 * np.linalg.norm(s_vec, axis=-1) * np.linalg.norm(y_vec, axis=-1)
        )
        w = good & ~done
        s_hist[head[w], r_idx[w]] = s_vec[w]
        y_hist[head[w], r_idx[w]] = y_vec[w]
        rho[head[w], r_idx[w]] = 1.0 / sy[w]
        head = np.where(w, (head + 1) % m, head)
        count = np.where(w, np.minimum(count + 1, m), count)

        failed = ~ok & ~done
        reset = failed & (count > 0)
        head = np.where(reset, 0, head)
        count = np.where(reset, 0, count)
        failed_for_good = failed & ~reset

        # --- stall stop: accepted steps with below-slack progress ---------
        if stall_iters > 0:
            progressed = (f - f_new) > f_slack
            stall = np.where(moved_lanes & ~progressed, stall + 1, 0).astype(np.int32)

        iters += np.where(~done, 1, 0).astype(np.int32)
        x, f, g = x_new, f_new, g_new
        done = done | failed_for_good | (pg_norm(x, g) <= tol)
        if stall_iters > 0:
            done = done | (stall >= stall_iters)
        if state_path:
            _save_iter_state(
                state_path,
                it + 1,
                dict(
                    x=x, f=f, g=g, iters=iters, n_fev=n_fev, s_hist=s_hist,
                    y_hist=y_hist, rho=rho, head=head, count=count,
                    stall=stall, done=done,
                ),
                fingerprint,
            )
        if progress is not None:
            progress(it, done)

    # Keep the sidecar after a max_iter-bounded exit with live lanes: a
    # rerun with a raised limit then continues mid-stage instead of
    # restarting.
    if state_path and os.path.exists(state_path) and bool(done.all()):
        os.remove(state_path)
    return HostLBFGSResult(
        x=x,
        f=f,
        g=g,
        iters=iters,
        n_fev=n_fev,
        converged=pg_norm(x, g) <= tol,
    )


def make_stage_optimizer_host(
    nll: Callable | None,
    q_sqrt,
    max_iter: int = 200,
    tol: float = 1e-4,
    history: int = 10,
    dtype=None,
    progress_every: int = 10,
    state_prefix: str | None = None,
    mesh=None,
    nll_batched: Callable | None = None,
):
    """``stage(p0_norm [R, P], gamma, unit_key=None) -> HostLBFGSResult``:
    one tempering stage of :func:`lbfgs_box_host` over a batched objective.

    The objective is ``nll_batched(p_b [B, P], gamma_sqrt) -> [B]`` when
    given (the NLL kernels' wrapper, differentiable through their autograd
    Function), else ``nll(p_b [B, P], q_sqrt, gamma_sqrt) -> [B]`` (the
    port's ``make_nll``, batched over the leading dimension). Each dispatch
    evaluates it on the batch and pulls a cotangent of ones back to the
    points: exact per-lane gradients, since each lane's NLL depends only on
    its own row. Points go to the device and dtype of the stage's
    ``p0_norm`` (``dtype`` overrides the dtype).

    Prints a progress line every ``progress_every`` iterations (0 disables).
    With ``state_prefix`` and a ``unit_key``, the optimizer state is
    checkpointed every iteration to ``<state_prefix>.lbfgs-<unit_key>.npz``
    and a rerun resumes mid-stage.

    With ``mesh`` (a :class:`~ode_uncertainty_tpu_torch.parallel.mesh.Mesh`),
    every dispatch is split over the mesh's devices: ``nll`` is then a
    factory, ``nll(device)`` returning the objective ``(p_b, q_sqrt,
    gamma_sqrt) -> [B]`` on that device (called once per device), and
    ``q_sqrt`` is copied once to each device. Dispatch widths are padded up
    to a multiple of the mesh size with copies of row 0 (composing with
    bucket compaction); each shard's value and gradient run on its device,
    all launched before any is read back; the host bookkeeping is the same.
    ``nll_batched`` and ``mesh`` are mutually exclusive.

    The line search tries one step per dispatch on the CPU and a ladder of 8
    on the card (``ODEUQ_LS_TRIALS`` overrides; ``ODEUQ_LS_WIDTH_CAP`` caps
    the ladder's dispatch width, 256 by default), as the reference does on
    its CPU and accelerator backends.
    """
    sharded_vg = None
    if mesh is not None:
        if nll_batched is not None:
            raise ValueError("nll_batched and mesh are mutually exclusive")
        from ode_uncertainty_tpu_torch.parallel.mesh import make_sharded_value_and_grad

        sharded_vg = make_sharded_value_and_grad(nll, q_sqrt, mesh)
    elif nll_batched is None:
        if nll is None:
            raise ValueError("give nll or nll_batched")
        nll_batched = lambda p, gamma_sqrt: nll(p, q_sqrt, gamma_sqrt)

    def stage(p0_norm, gamma, unit_key=None):
        p0_t = torch.as_tensor(p0_norm)
        dt = dtype or p0_t.dtype
        device = p0_t.device
        gamma_sqrt = torch.sqrt(torch.as_tensor(float(gamma), dtype=dt))
        f32 = dt == torch.float32

        def vagb(x):
            if sharded_vg is not None:
                return sharded_vg(x, gamma, dt)
            fb, gb = value_and_grad(lambda p: nll_batched(p, gamma_sqrt), torch.as_tensor(x, dtype=dt, device=device))
            return fb.cpu().numpy(), gb.cpu().numpy()

        t0 = time.perf_counter()

        first_it = [None]  # first callback index: marginal rate stays honest
        # across a mid-stage resume

        def heartbeat(it, done):
            if first_it[0] is None:
                first_it[0] = it
            if progress_every and (it + 1) % progress_every == 0:
                el = time.perf_counter() - t0
                n = max(it + 1 - first_it[0], 1)
                print(
                    f"    [lbfgs] iter {it + 1}/{max_iter}: {int((~done).sum())}/{len(done)} "
                    f"lanes active, {el:.0f}s ({el / n:.1f}s/iter)",
                    flush=True,
                )

        state_path = (
            f"{state_prefix}.lbfgs-{unit_key}.npz"
            if state_prefix is not None and unit_key is not None
            else None
        )
        # On the CPU the extra trial rows of a ladder cost linearly, so the
        # sequential search stays the CPU default; on the card a dispatch's
        # time barely depends on its width.
        on_cpu = (mesh.devices[0] if mesh is not None else device).type == "cpu"
        default_trials = "1" if on_cpu else "8"
        return lbfgs_box_host(
            vagb,
            p0_t.detach().cpu().numpy().astype(np.float64),
            max_iter=max_iter,
            tol=tol,
            history=history,
            f32=f32,
            ls_trials=int(os.environ.get("ODEUQ_LS_TRIALS", default_trials)),
            ls_width_cap=int(os.environ.get("ODEUQ_LS_WIDTH_CAP", "256")),
            progress=heartbeat,
            state_path=state_path,
            state_token=f"gamma={float(gamma):.17g}",
        )

    return stage
