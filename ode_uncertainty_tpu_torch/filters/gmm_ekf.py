"""Gaussian-mixture square-root EKF with adaptive split/merge (port of
``ode_uncertainty_tpu/filters/gmm_ekf.py``).

A bank of sqrt-EKF components whose population adapts to the local
nonlinearity:

  * **split**: every component whose look-ahead nonlinearity estimate (a
    second difference of the RHS) exceeds the threshold splits along its
    covariance's top eigenvector, most nonlinear first, bounded by free
    capacity; the covariance loses the displaced rank-1 term by a Cholesky
    downdate.
  * **merge**: all sufficiently close pairs under the Jeffrey divergence are
    moment-matched greedily (closest pair first, each component in at most
    one pair per step); components slated for splitting are excluded.
  * **invalidate**: components with non-finite means, below-minimum weight,
    or farther than the distance threshold from every other component (in
    some dimension) are dropped.

The bank has a fixed capacity of ``max_components`` slots with an ``active``
mask, as in the JAX package: every step runs the same operations on every
slot, with masked selects in place of data-dependent shapes, and nothing is
read back to the host. The greedy merge is ``max_components // 2`` masked
rounds; splits scatter into free slots by rank.

The split direction, the covariance's top eigenvector, comes from a cyclic
Jacobi sweep (:func:`top_eigenpair`) where the JAX package calls its
eigensolver: elementwise operations, with no solver library call and no
host synchronization, so a CUDA graph captures the whole step, and the CPU
and the GPU round it alike. The eigenvector's sign, which the JAX package
leaves to its eigensolver, is fixed (largest-magnitude entry positive), so
both devices put a split's two halves in the same slots; of equal top
eigenvalues the last is taken, as from an ascending eigensolver.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ode_uncertainty_tpu_torch.filters.cov_updates import DiagonalUpdate
from ode_uncertainty_tpu_torch.filters.sqrt_ekf import EKFState, SqrtEKF
from ode_uncertainty_tpu_torch.ops.chol_update import chol_update
from ode_uncertainty_tpu_torch.ops.sqrt_linalg import jeffrey_gaussian_sqrt, pdf_gaussian_sqrt, sqrt_sum

_BIG = 1e30
JACOBI_SWEEPS = 8  # cyclic sweeps: quadratic convergence, to rounding for n <= 8


def top_eigenpair(a: torch.Tensor, sweeps: int = JACOBI_SWEEPS):
    """Largest eigenvalue [...] and its unit eigenvector [..., n] of the
    symmetric a [..., n, n], by cyclic Jacobi rotations (each zeroes one
    off-diagonal pair), the eigenvector's largest-magnitude entry positive."""
    n = a.shape[-1]
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq, app, aqq = a[..., p, q], a[..., p, p], a[..., q, q]
                zero = apq == 0
                theta = (aqq - app) / torch.where(zero, torch.ones_like(apq), 2.0 * apq)
                sgn = torch.where(theta >= 0, 1.0, -1.0).to(a.dtype)
                t = torch.where(zero, torch.zeros_like(apq), sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0)))
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                # a <- J^T a J and v <- v J, J the rotation in the (p, q) plane
                for m in (a, v):
                    cp, cq = m[..., :, p].clone(), m[..., :, q].clone()
                    m[..., :, p] = c[..., None] * cp - s[..., None] * cq
                    m[..., :, q] = s[..., None] * cp + c[..., None] * cq
                rp, rq = a[..., p, :].clone(), a[..., q, :].clone()
                a[..., p, :] = c[..., None] * rp - s[..., None] * rq
                a[..., q, :] = s[..., None] * rp + c[..., None] * rq
    evals = torch.diagonal(a, dim1=-2, dim2=-1)
    # of equal largest eigenvalues the last, as the last column of an
    # ascending eigensolver's output (the JAX package's choice for an
    # isotropic covariance)
    top = (n - 1) - torch.argmax(torch.flip(evals, dims=(-1,)), dim=-1, keepdim=True)
    lam = torch.gather(evals, -1, top)[..., 0]
    d = torch.gather(v, -1, top[..., None, :].expand(*v.shape[:-1], 1))[..., 0]
    lead = torch.gather(d, -1, torch.argmax(torch.abs(d), dim=-1, keepdim=True))
    return lam, d * torch.where(lead < 0, -1.0, 1.0).to(d.dtype)


@dataclasses.dataclass(frozen=True)
class GMMState:
    """Mixture bank (K = capacity, n = flat state size)."""

    t: torch.Tensor  # []
    means: torch.Tensor  # [K, N, D]
    P_sqrt: torch.Tensor  # [K, n, n]
    eps: torch.Tensor  # [K, N, D]
    weights: torch.Tensor  # [K] (inactive slots have weight 0)
    active: torch.Tensor  # [K] bool

    def replace(self, **kw) -> "GMMState":
        return dataclasses.replace(self, **kw)


def _sub_state(state: GMMState, obs_dim: int) -> EKFState:
    """The bank as one batch of sqrt-EKF states."""
    k, dtype, device = state.means.shape[0], state.means.dtype, state.means.device
    return EKFState(
        t=state.t,
        x=state.means,
        eps=state.eps,
        P_sqrt=state.P_sqrt,
        y_hat=torch.zeros((k, obs_dim), dtype=dtype, device=device),
        S_sqrt=torch.zeros((k, obs_dim, obs_dim), dtype=dtype, device=device),
    )


@dataclasses.dataclass(frozen=True)
class GMMSqrtEKF:
    """Adaptive Gaussian-mixture sqrt-EKF."""

    cov_update: object = DiagonalUpdate()
    max_components: int = 8
    nl_threshold: float = 0.1
    merge_threshold: float = 1.0
    split_displacement: float = 0.5
    distance_threshold: float = 100.0
    min_weight: float = 0.01
    disable_cov_update: bool = False

    def _ekf(self) -> SqrtEKF:
        return SqrtEKF(cov_update=self.cov_update, disable_cov_update=self.disable_cov_update)

    def init_state(self, t0, x0: torch.Tensor, p0_sqrt: torch.Tensor) -> GMMState:
        k = self.max_components
        dtype, device = x0.dtype, x0.device
        n = x0.numel()
        first = torch.arange(k, device=device) == 0
        means = torch.zeros((k, *x0.shape), dtype=dtype, device=device)
        means[0] = x0
        chols = torch.zeros((k, n, n), dtype=dtype, device=device)
        chols[0] = p0_sqrt.to(dtype)
        return GMMState(
            t=torch.as_tensor(t0, dtype=dtype, device=device),
            means=means,
            P_sqrt=chols,
            eps=torch.zeros((k, *x0.shape), dtype=dtype, device=device),
            weights=first.to(dtype),
            active=first,
        )

    # ----------------------------------------------------------- adaptation
    def _nonlinearity(self, solver, rhs, params, state: GMMState) -> torch.Tensor:
        """Look-ahead curvature estimate per component: ||(f(x') - f(x))/h||."""
        x = state.means
        dx = rhs(state.t, x, params)
        x_next, _ = solver.step(rhs, params, state.t, x)
        dx_next = rhs(state.t + solver.h, x_next, params)
        nl = torch.linalg.vector_norm((dx_next[:, 0] - dx[:, 0]) / solver.h, dim=-1)
        return torch.where(state.active, nl, torch.full_like(nl, -float("inf")))

    def _split_many(self, state: GMMState, nl: torch.Tensor) -> GMMState:
        """Splits every component with nl > threshold, most nonlinear first,
        bounded by free capacity. The r-th-ranked splitter scatters its twin
        into the r-th free slot."""
        k = self.max_components
        slots = torch.arange(k, device=nl.device)
        order = torch.argsort(-nl, stable=True)  # descending nonlinearity
        num_above = torch.sum(nl > self.nl_threshold)
        capacity = k - torch.sum(state.active)
        num_splits = torch.minimum(num_above, capacity)

        # rank of each component in the split order; rank < num_splits splits
        rank = torch.argsort(order)
        is_split = (rank < num_splits) & state.active

        # r-th free (inactive) slot, by position; twin slot of each splitter
        free_order = torch.argsort(state.active.to(torch.int8), stable=True)
        twin = free_order[rank.clamp(0, k - 1)]

        chol = state.P_sqrt
        lam, d = top_eigenpair(chol @ chol.transpose(-1, -2))
        disp = self.split_displacement * torch.sqrt(torch.clamp(lam, min=0.0))[:, None] * d
        chol_zero = torch.all(torch.abs(chol) < 1e-6, dim=-1).all(dim=-1)
        chol_dn = chol_update(chol, d, -(self.split_displacement**2) * lam)
        keep_old = chol_zero | ~torch.isfinite(chol_dn).all(dim=-1).all(dim=-1)
        chol_dn = torch.where(keep_old[:, None, None], chol, chol_dn)

        dm = disp.reshape(state.means.shape)
        split3 = is_split[:, None, None]
        means = torch.where(split3, state.means + dm, state.means)
        chols = torch.where(split3, chol_dn, chol)
        weights = torch.where(is_split, state.weights * 0.5, state.weights)

        # twins (mean - dm, the same downdated factor, half weight) land in
        # the free slots: slot s receives splitter r when twin[r] == s
        lands = (twin[None, :] == slots[:, None]) & is_split[None, :]  # [slot, splitter]
        src = torch.argmax(lands.to(torch.int8), dim=1)
        hit = lands.any(dim=1)
        hit3 = hit[:, None, None]
        means = torch.where(hit3, (state.means - dm)[src], means)
        chols = torch.where(hit3, chol_dn[src], chols)
        weights = torch.where(hit, (state.weights * 0.5)[src], weights)
        active = state.active | hit
        eps = torch.where(hit3, state.eps[src], state.eps)
        return state.replace(means=means, P_sqrt=chols, weights=weights, active=active, eps=eps)

    def _merge_pairs(self, state: GMMState, exclude: torch.Tensor) -> GMMState:
        """Greedy pairwise merging: repeatedly moment-match the closest
        still-unmerged pair under the Jeffrey threshold (each component in at
        most one pair per step). ``exclude`` masks components slated for
        splitting."""
        k = self.max_components
        slots = torch.arange(k, device=state.means.device)
        off_diag = ~torch.eye(k, dtype=torch.bool, device=slots.device)
        fresh = state.active & ~exclude
        s = state
        for _ in range(k // 2):
            flat = s.means.reshape(k, -1)
            dist = jeffrey_gaussian_sqrt(flat[:, None, :], flat[None, :, :], s.P_sqrt[:, None], s.P_sqrt[None, :])
            ok = fresh[:, None] & fresh[None, :] & off_diag
            dist = torch.where(ok, dist, torch.full_like(dist, _BIG)).reshape(-1)
            # indices as 1-element tensors: no host synchronization
            idx = torch.argmin(dist).reshape(1)
            i, j = idx // k, idx % k
            can = dist[idx][0] < self.merge_threshold

            wi, wj = s.weights[i][0], s.weights[j][0]
            w = wi + wj
            safe_w = torch.where(w > 0, w, torch.ones_like(w))
            mi, mj = flat[i][0], flat[j][0]
            m = (wi * mi + wj * mj) / safe_w
            di = (mi - m) * torch.sqrt(wi / safe_w)
            dj = (mj - m) * torch.sqrt(wj / safe_w)
            merged = sqrt_sum(
                torch.sqrt(wi / safe_w) * s.P_sqrt[i][0],
                torch.sqrt(wj / safe_w) * s.P_sqrt[j][0],
                di[:, None],
                dj[:, None],
            )

            at_i = can & (slots == i)
            at_j = can & (slots == j)
            s = s.replace(
                means=torch.where(at_i[:, None, None], m.reshape(s.means.shape[1:]), s.means),
                P_sqrt=torch.where(at_i[:, None, None], merged, s.P_sqrt),
                weights=torch.where(at_j, torch.zeros_like(s.weights), torch.where(at_i, w, s.weights)),
                active=s.active & ~at_j,
            )
            # a merged component may not merge again this step
            fresh = fresh & ~(at_i | at_j)
        return s

    def _invalidate(self, state: GMMState) -> GMMState:
        """Drops non-finite components, below-minimum-weight components and
        components farther than the distance threshold from every other
        active component in some dimension; keeps at least one."""
        k = self.max_components
        flat = state.means.reshape(k, -1)
        finite = torch.isfinite(flat).all(dim=-1)
        delta = torch.abs(flat[None, :, :] - flat[:, None, :])  # [K, K, n]
        far_pair = (delta > self.distance_threshold).any(dim=-1)  # [K, K]
        other_ok = state.active[None, :] & ~torch.eye(k, dtype=torch.bool, device=flat.device)
        # far from all other active components -> invalid
        alone = (far_pair | ~other_ok).all(dim=1) & other_ok.any(dim=1)
        keep = state.active & finite & ~alone & (state.weights >= self.min_weight)
        keep = torch.where(keep.any(), keep, state.active)  # never drop all
        weights = torch.where(keep, state.weights, torch.zeros_like(state.weights))
        total = torch.clamp(weights.sum(), min=1e-30)
        return state.replace(active=keep, weights=weights / total)

    # ------------------------------------------------------------- predict
    def make_predict(self, solver, rhs: Callable):
        ekf_predict = self._ekf().make_predict(solver, rhs)

        def predict(state: GMMState, params, q_sqrt, gamma_sqrt) -> GMMState:
            # propagate all components, invalidate, estimate the
            # nonlinearity, merge close pairs (split candidates excluded),
            # then split into the slots freed by merging
            out = ekf_predict(_sub_state(state, 0), params, q_sqrt, gamma_sqrt)
            state = state.replace(t=state.t + solver.h, means=out.x, P_sqrt=out.P_sqrt, eps=out.eps)
            state = self._invalidate(state)
            nl = self._nonlinearity(solver, rhs, params, state)
            state = self._merge_pairs(state, exclude=nl > self.nl_threshold)
            return self._split_many(state, nl)

        return predict

    # ------------------------------------------------------------- correct
    def make_correct(self):
        ekf_correct = self._ekf().make_correct(unrolled=True)

        def correct(state: GMMState, H, y, r_sqrt) -> GMMState:
            out = ekf_correct(_sub_state(state, H.shape[0]), H, y, r_sqrt)
            liks = pdf_gaussian_sqrt(y, out.y_hat, out.S_sqrt)
            w = state.weights * torch.where(state.active, liks, torch.zeros_like(liks))
            total = w.sum()
            # degenerate case (all likelihoods ~0): keep the previous weights
            w = torch.where(total > 1e-30, w / torch.clamp(total, min=1e-30), state.weights)
            return state.replace(means=out.x, P_sqrt=out.P_sqrt, weights=w)

        return correct

    # ------------------------------------------------------------ estimate
    @staticmethod
    def mixture_moments(state: GMMState):
        """Returns (mean [N, D], covariance [n, n]) of the mixture."""
        k = state.means.shape[0]
        flat = state.means.reshape(k, -1)
        w = state.weights / torch.clamp(state.weights.sum(), min=1e-30)
        mean = w @ flat
        dev = flat - mean[None, :]
        covs = state.P_sqrt @ state.P_sqrt.transpose(-1, -2)
        cov = torch.einsum("k,kij->ij", w, covs) + torch.einsum("k,ki,kj->ij", w, dev, dev)
        return mean.reshape(state.means.shape[1:]), cov
