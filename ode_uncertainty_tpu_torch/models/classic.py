"""Classic ODE test systems (port of ``ode_uncertainty_tpu/models/classic.py``).

State convention: y has shape [..., N, D]; for second-order systems row 0 is
the position and row 1 the velocity, and the RHS returns [velocity,
acceleration]. Scalar parameters broadcast over the leading batch dims.
"""

from __future__ import annotations

import torch

from ode_uncertainty_tpu_torch.models.base import ODEModel, as_params, batch_param


def exponential(growth_factor: float = 1.0) -> ODEModel:
    """dy/dt = a * y  (N=1, D=1) with closed-form solution."""

    def rhs(t, y, params):
        del t
        return batch_param(params, "growth_factor", 2) * y

    def solution(ts, x0, params):
        return x0[0][None, :] * torch.exp(params["growth_factor"] * ts)[:, None]

    return ODEModel(
        "exponential", 1, 1, rhs, as_params(growth_factor=growth_factor), solution=solution
    )


def logistic(growth_rate: float = 1.0, carrying_capacity: float = 1.0) -> ODEModel:
    """Logistic growth (N=1, D=1) with closed-form solution."""

    def rhs(t, y, params):
        del t
        r = batch_param(params, "growth_rate", 2)
        k = batch_param(params, "carrying_capacity", 2)
        return r * y * (1.0 - y / k)

    def solution(ts, x0, params):
        # x(t) = K / (1 + (K - x0)/x0 * exp(-r t)), broadcast over time.
        k = params["carrying_capacity"]
        r = params["growth_rate"]
        y0 = x0[0]  # [D]
        return k / (1.0 + ((k - y0) / y0)[None, :] * torch.exp(-r * ts)[:, None])

    return ODEModel(
        "logistic",
        1,
        1,
        rhs,
        as_params(growth_rate=growth_rate, carrying_capacity=carrying_capacity),
        solution=solution,
    )


def lotka_volterra(
    alpha: float = 1.5, beta: float = 1.0, gamma: float = 3.0, delta: float = 1.0
) -> ODEModel:
    """Predator-prey system (N=1, D=2)."""

    def rhs(t, y, params):
        del t
        prey, pred = y[..., 0], y[..., 1]
        d_prey = batch_param(params, "alpha") * prey - batch_param(params, "beta") * prey * pred
        d_pred = batch_param(params, "delta") * prey * pred - batch_param(params, "gamma") * pred
        return torch.stack([d_prey, d_pred], dim=-1)

    return ODEModel(
        "lotka_volterra",
        1,
        2,
        rhs,
        as_params(alpha=alpha, beta=beta, gamma=gamma, delta=delta),
    )


def lorenz(sigma: float = 10.0, beta: float = 8.0 / 3.0, rho: float = 28.0) -> ODEModel:
    """Chaotic Lorenz system (N=1, D=3)."""

    def rhs(t, y, params):
        del t
        a, b, c = y[..., 0], y[..., 1], y[..., 2]
        return torch.stack(
            [
                batch_param(params, "sigma") * (b - a),
                a * (batch_param(params, "rho") - c) - b,
                a * b - batch_param(params, "beta") * c,
            ],
            dim=-1,
        )

    return ODEModel("lorenz", 1, 3, rhs, as_params(sigma=sigma, beta=beta, rho=rho))


def pendulum(length: float = 3.0) -> ODEModel:
    """Nonlinear pendulum (N=2, D=1)."""

    def rhs(t, y, params):
        del t
        pos, vel = y[..., 0, :], y[..., 1, :]
        acc = -9.81 / batch_param(params, "length") * torch.sin(pos)
        return torch.stack([vel, acc], dim=-2)

    return ODEModel("pendulum", 2, 1, rhs, as_params(length=length))


def van_der_pol(damping: float = 5.0) -> ODEModel:
    """Van der Pol oscillator (N=2, D=1), stiff-ish for large damping."""

    def rhs(t, y, params):
        del t
        pos, vel = y[..., 0, :], y[..., 1, :]
        acc = batch_param(params, "damping") * (1.0 - pos**2) * vel - pos
        return torch.stack([vel, acc], dim=-2)

    return ODEModel("van_der_pol", 2, 1, rhs, as_params(damping=damping))


def lcao(
    lin_coeff: float = 1.0, cubic_coeff: float = 2.0, coupling_coeff: float = 0.5
) -> ODEModel:
    """Linearly coupled anharmonic oscillators (N=2, D=2).

    Two cubic oscillators coupled by exchanging positions (flip along D).
    """

    def rhs(t, y, params):
        del t
        pos, vel = y[..., 0, :], y[..., 1, :]
        acc = (
            -batch_param(params, "lin_coeff") * pos
            - batch_param(params, "cubic_coeff") * pos**3
            - batch_param(params, "coupling_coeff") * torch.flip(pos, dims=(-1,))
        )
        return torch.stack([vel, acc], dim=-2)

    return ODEModel(
        "lcao",
        2,
        2,
        rhs,
        as_params(lin_coeff=lin_coeff, cubic_coeff=cubic_coeff, coupling_coeff=coupling_coeff),
    )


def rlc_circuit(
    resistance: float = 1.0, inductance: float = 1.0, capacitance: float = 1.0
) -> ODEModel:
    """Series RLC circuit (N=2, D=1) with closed-form solutions in all
    damping regimes (test oracle)."""

    def rhs(t, y, params):
        del t
        q, dq = y[..., 0, :], y[..., 1, :]
        r = batch_param(params, "resistance")
        ind = batch_param(params, "inductance")
        cap = batch_param(params, "capacitance")
        d2q = -r / ind * dq - q / (ind * cap)
        return torch.stack([dq, d2q], dim=-2)

    # Damping regime is decided at model-construction time from concrete
    # floats (the analytic solution is a test oracle).
    delta = 0.5 * resistance / inductance
    omega0_sq = 1.0 / (inductance * capacitance)

    def solution(ts, x0, params):
        del params
        q0 = x0[0]  # [D]
        tt = ts[:, None]
        if omega0_sq - delta**2 > 1e-6:  # underdamped
            om = (omega0_sq - delta**2) ** 0.5
            return q0[None, :] * (
                (torch.cos(om * tt) + (delta / om) * torch.sin(om * tt)) * torch.exp(-delta * tt)
            )
        elif delta**2 - omega0_sq > 1e-6:  # overdamped
            lam = (delta**2 - omega0_sq) ** 0.5
            return (
                0.5
                * q0[None, :]
                / lam
                * ((lam + delta) * torch.exp(lam * tt) + (lam - delta) * torch.exp(-lam * tt))
                * torch.exp(-delta * tt)
            )
        else:  # critically damped
            return q0[None, :] * (1.0 + delta * tt) * torch.exp(-delta * tt)

    return ODEModel(
        "rlc_circuit",
        2,
        1,
        rhs,
        as_params(resistance=resistance, inductance=inductance, capacitance=capacitance),
        solution=solution,
    )
