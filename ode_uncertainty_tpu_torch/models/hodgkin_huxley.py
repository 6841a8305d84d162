"""Hodgkin-Huxley neuron models, Pospischil-style kinetics (port of
``ode_uncertainty_tpu/models/hodgkin_huxley.py``).

State layout (N = 1, axis 1 holds channels): ``[V, m, h, n, p, q, r, u]``
truncated to the variant's dimension (``full`` 8, ``reduced-1`` 7,
``reduced-4`` 4). The initial state is parameter dependent: the gating
variables start at their steady-state values for V0.

Differences from the JAX package:
  * the rate laws use the native ``torch.expm1``. The JAX package picks the
    native ``expm1`` on the CPU and Kahan's form elsewhere only because its
    TPU compiler cannot lower ``expm1``; PyTorch and CUDA have it, so the
    port, its tests (against the JAX package on the CPU) and the CUDA
    kernel (``expm1``/``expm1f``) all use the native one;
  * the multi-compartment RHS evaluates the compartments as a trailing axis
    of the batch instead of a ``vmap``;
  * channel values are broadcast against each other before they are
    stacked, so a batch of parameters [...] meets an unbatched state.
"""

from __future__ import annotations

from typing import Dict

import torch

from ode_uncertainty_tpu_torch.models.base import ODEModel, Params, as_params

_VARIANT_DIMS = {"full": 8, "reduced-1": 7, "reduced-4": 4}

_SINGLE_DEFAULTS = dict(
    C=1.0,
    A=8.3e-5,
    g_Na=25.0,
    E_Na=53.0,
    g_K=7.0,
    E_K=-107.0,
    g_leak=0.1,
    E_leak=-70.0,
    V_T=-60.0,
    g_M=0.01,
    tau_max=4e3,
    g_L=0.01,
    E_Ca=120.0,
    g_T=0.01,
    V_x=2.0,
)


# --- channel rate constants (alpha/beta), vectorized in V ------------------
def _vtrap(x, scale):
    """x / expm1(x / scale): the rate-law denominator (0/0 at x = 0, as in
    the JAX package)."""
    return x / torch.expm1(x / scale)


def alpha_m(v, v_t):
    return 0.32 * _vtrap(-(v - v_t - 13.0), 4.0)


def beta_m(v, v_t):
    return 0.28 * _vtrap(v - v_t - 40.0, 5.0)


def alpha_n(v, v_t):
    return 0.032 * _vtrap(-(v - v_t - 15.0), 5.0)


def beta_n(v, v_t):
    return 0.5 * torch.exp(-(v - v_t - 10.0) / 40.0)


def alpha_h(v, v_t):
    return 0.128 * torch.exp(-(v - v_t - 17.0) / 18.0)


def beta_h(v, v_t):
    return 4.0 / (1.0 + torch.exp(-(v - v_t - 40.0) / 5.0))


def alpha_q(v):
    return 0.055 * _vtrap(-(v + 27.0), 3.8)


def beta_q(v):
    return 0.94 * torch.exp(-(v + 75.0) / 17.0)


def alpha_r(v):
    return 0.000457 * torch.exp(-(v + 13.0) / 50.0)


def beta_r(v):
    return 0.0065 / (torch.exp(-(v + 15.0) / 28.0) + 1.0)


def tau_p(v, tau_max):
    return tau_max / (3.3 * torch.exp((v + 35.0) / 20.0) + torch.exp(-(v + 35.0) / 20.0))


def tau_u(v, v_x):
    return (30.8 + 211.4 + torch.exp((v + v_x + 113.2) / 5.0)) / (
        3.7 * (1.0 + torch.exp((v + v_x + 84.0) / 3.2))
    )


# --- steady states ----------------------------------------------------------
def _inf(alpha, beta):
    return alpha / (alpha + beta)


def p_inf(v):
    return 1.0 / (1.0 + torch.exp(-(v + 35.0) / 10.0))


def s_inf(v, v_x):
    return 1.0 / (1.0 + torch.exp(-(v + v_x + 57.0) / 6.2))


def u_inf(v, v_x):
    return 1.0 / (1.0 + torch.exp((v + v_x + 81.0) / 4.0))


def steady_state(v0, params: Params, variant: str) -> torch.Tensor:
    """Channel steady states at voltage v0 -> [..., D] state vector."""
    v0 = torch.as_tensor(v0)
    v_t = params["V_T"]
    vals = [
        v0,
        _inf(alpha_m(v0, v_t), beta_m(v0, v_t)),
        _inf(alpha_h(v0, v_t), beta_h(v0, v_t)),
        _inf(alpha_n(v0, v_t), beta_n(v0, v_t)),
        p_inf(v0),
        _inf(alpha_q(v0), beta_q(v0)),
        _inf(alpha_r(v0), beta_r(v0)),
        u_inf(v0, params["V_x"]),
    ]
    return torch.stack(torch.broadcast_tensors(*vals[: _VARIANT_DIMS[variant]]), dim=-1)


# --- membrane currents -------------------------------------------------------
def input_current(t):
    """Square stimulus pulse, 210 pA for 10 <= t <= 90."""
    t = torch.as_tensor(t)
    on = (t >= 10.0) & (t <= 90.0)
    return torch.where(on, torch.full_like(t, 210.0 * 1e-6), torch.zeros_like(t))


def _channel_derivs(t, s, params: Params, variant: str):
    """RHS over a compartment's channel state s [..., D] -> [..., D]."""
    dim = _VARIANT_DIMS[variant]
    v = s[..., 0]
    v_t = params["V_T"]

    def gate(a, b, g):
        return a * (1.0 - g) - b * g

    dm = gate(alpha_m(v, v_t), beta_m(v, v_t), s[..., 1])
    dh = gate(alpha_h(v, v_t), beta_h(v, v_t), s[..., 2])
    dn = gate(alpha_n(v, v_t), beta_n(v, v_t), s[..., 3])

    i_na = params["g_Na"] * s[..., 1] ** 3 * s[..., 2] * (params["E_Na"] - v)
    i_k = params["g_K"] * s[..., 3] ** 4 * (params["E_K"] - v)
    i_leak = params["g_leak"] * (params["E_leak"] - v)
    total = i_na + i_k + i_leak

    derivs = [dm, dh, dn]
    if dim >= 7:
        dp = (p_inf(v) - s[..., 4]) / tau_p(v, params["tau_max"])
        dq = gate(alpha_q(v), beta_q(v), s[..., 5])
        dr = gate(alpha_r(v), beta_r(v), s[..., 6])
        derivs += [dp, dq, dr]
        total = total + params["g_M"] * s[..., 4] * (params["E_K"] - v)
        total = total + params["g_L"] * s[..., 5] ** 2 * s[..., 6] * (params["E_Ca"] - v)
    if dim == 8:
        du = (u_inf(v, params["V_x"]) - s[..., 7]) / tau_u(v, params["V_x"])
        derivs.append(du)
        total = total + (
            params["g_T"] * s_inf(v, params["V_x"]) ** 2 * s[..., 7] * (params["E_Ca"] - v)
        )

    dv = (total + input_current(t).to(v.dtype) / params["A"]) / params["C"]
    return torch.stack(torch.broadcast_tensors(dv, *derivs), dim=-1)


def hodgkin_huxley(variant: str = "reduced-1", **overrides: float) -> ODEModel:
    """Single-compartment Hodgkin-Huxley model (N = 1, D = 8/7/4)."""
    if variant not in _VARIANT_DIMS:
        raise ValueError(f"Unknown Hodgkin-Huxley variant: {variant!r}")
    dim = _VARIANT_DIMS[variant]
    defaults = dict(_SINGLE_DEFAULTS)
    for k, v in overrides.items():
        if k not in defaults:
            raise KeyError(f"Unknown Hodgkin-Huxley parameter {k!r}")
        defaults[k] = v

    def rhs(t, y, p):
        return _channel_derivs(t, y[..., 0, :], p, variant)[..., None, :]

    def initial_value(x0, p):
        return steady_state(x0[..., 0, 0], p, variant)[..., None, :]

    return ODEModel(
        f"hodgkin_huxley_{variant}", 1, dim, rhs, as_params(**defaults), initial_value_fn=initial_value
    )


def multi_compartment_hodgkin_huxley(
    variant: str = "reduced-1",
    num_compartments: int = 2,
    coupling_coeffs=(1.0,),
    C: float = 1.0,
    **per_compartment: list,
) -> ODEModel:
    """Multi-compartment Hodgkin-Huxley (N = 1, D = num_compartments * dim).

    Compartments are coupled through a tridiagonal conductance matrix G built
    from ``coupling_coeffs`` (length num_compartments - 1); ``G @ V / C`` is
    added to each compartment's dV/dt. Per-compartment parameters are vectors
    of length ``num_compartments`` (scalars are broadcast).
    """
    if variant not in _VARIANT_DIMS:
        raise ValueError(f"Unknown Hodgkin-Huxley variant: {variant!r}")
    dim = _VARIANT_DIMS[variant]
    ncomp = num_compartments
    unknown = set(per_compartment) - set(_SINGLE_DEFAULTS)
    if unknown:
        raise KeyError(f"Unknown Hodgkin-Huxley parameters: {sorted(unknown)}")

    f64 = torch.float64
    defaults: Dict[str, torch.Tensor] = {
        "coupling_coeffs": torch.as_tensor(coupling_coeffs, dtype=f64)[None, :],
        "C": torch.as_tensor([C], dtype=f64),
    }
    for k, dv in _SINGLE_DEFAULTS.items():
        if k == "C":
            continue
        arr = torch.atleast_1d(torch.as_tensor(per_compartment.get(k, dv), dtype=f64))
        defaults[k] = torch.broadcast_to(arr, (ncomp,)).clone()

    def _coupling_matrix(coeffs):
        """Tridiagonal G [..., C, C]: off-diagonals +c_i, diagonal minus the
        sum of the incident c."""
        off = torch.diag_embed(coeffs, 1) + torch.diag_embed(coeffs, -1)
        zero = torch.zeros_like(coeffs[..., :1])
        deg = torch.cat([coeffs, zero], -1) + torch.cat([zero, coeffs], -1)
        return off - torch.diag_embed(deg)

    def _per_comp_params(p: Params) -> Params:
        return {k: torch.broadcast_to(p[k], (*p[k].shape[:-1], ncomp)) for k in _SINGLE_DEFAULTS}

    def rhs(t, y, p):
        batch = y.shape[:-2]
        states = y.reshape(*batch, ncomp, dim)
        d_states = _channel_derivs(t, states, _per_comp_params(p), variant)  # [..., C, D]
        g = _coupling_matrix(p["coupling_coeffs"][..., 0, :])
        v_coupled = (g @ states[..., 0][..., None])[..., 0]  # [..., C]
        dv = d_states[..., :1] + (v_coupled / p["C"])[..., None]
        d_states = torch.cat([dv, d_states[..., 1:]], dim=-1)
        return d_states.reshape(*d_states.shape[:-2], 1, ncomp * dim)

    def initial_value(x0, p):
        # x0: [..., 1, C] initial voltages, one per compartment
        p = {k: v.to(x0.device) for k, v in p.items()}
        v0 = torch.broadcast_to(x0[..., 0, :], (*x0.shape[:-2], ncomp))
        states = steady_state(v0, _per_comp_params(p), variant)  # [..., C, D]
        return states.reshape(*states.shape[:-2], 1, ncomp * dim)

    return ODEModel(
        f"hodgkin_huxley_{variant}_x{ncomp}",
        1,
        ncomp * dim,
        rhs,
        defaults,
        initial_value_fn=initial_value,
    )
