"""Butcher tableaus for embedded Runge-Kutta pairs.

The port keeps its own copy of ``ode_uncertainty_tpu/solvers/tableaus.py``
(pure data): Heun-Euler 1(2), Bogacki-Shampine 3(2), Runge-Kutta-Fehlberg
4(5), Dormand-Prince 6(5).

Convention: ``b_sol`` are the weights of the propagated solution and
``b_err`` those of the embedded comparison solution; the local truncation
error estimate is ``eps = |h * sum_i (b_err_i - b_sol_i) k_i|``.

Coefficients are Python floats; steppers skip zero entries, so the unrolled
stage loop does no structurally-zero work.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from fractions import Fraction as F


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    """Explicit embedded RK tableau (strictly lower-triangular A)."""

    name: str
    a: Tuple[Tuple[float, ...], ...]  # [S][S]
    b_sol: Tuple[float, ...]  # [S] propagated-solution weights
    b_err: Tuple[float, ...]  # [S] embedded-estimator weights
    c: Tuple[float, ...]  # [S]

    @property
    def num_stages(self) -> int:
        return len(self.c)


def _row(*xs) -> Tuple[float, ...]:
    return tuple(float(x) for x in xs)


# The standard embedded pair: propagate the order-2 Heun solution, estimate
# the error against the order-1 Euler step (as the JAX package does).
HEUN_EULER = ButcherTableau(
    name="heun_euler",
    a=(
        _row(0, 0),
        _row(1, 0),
    ),
    b_sol=_row(F(1, 2), F(1, 2)),
    b_err=_row(1, 0),
    c=_row(0, 1),
)

BS32 = ButcherTableau(
    name="bs32",
    a=(
        _row(0, 0, 0, 0),
        _row(F(1, 2), 0, 0, 0),
        _row(0, F(3, 4), 0, 0),
        _row(F(2, 9), F(1, 3), F(4, 9), 0),
    ),
    b_sol=_row(F(2, 9), F(1, 3), F(4, 9), 0),
    b_err=_row(F(7, 24), F(1, 4), F(1, 3), F(1, 8)),
    c=_row(0, F(1, 2), F(3, 4), 1),
)

RKF45 = ButcherTableau(
    name="rkf45",
    a=(
        _row(0, 0, 0, 0, 0, 0),
        _row(F(1, 4), 0, 0, 0, 0, 0),
        _row(F(3, 32), F(9, 32), 0, 0, 0, 0),
        _row(F(1932, 2197), F(-7200, 2197), F(7296, 2197), 0, 0, 0),
        _row(F(439, 216), -8, F(3680, 513), F(-845, 4104), 0, 0),
        _row(F(-8, 27), 2, F(-3544, 2565), F(1859, 4104), F(-11, 40), 0),
    ),
    b_sol=_row(F(25, 216), 0, F(1408, 2565), F(2197, 4104), F(-1, 5), 0),
    b_err=_row(F(16, 135), 0, F(6656, 12825), F(28561, 56430), F(-9, 50), F(2, 55)),
    c=_row(0, F(1, 4), F(3, 8), F(12, 13), 1, F(1, 2)),
)

DOPRI65 = ButcherTableau(
    name="dopri65",
    a=(
        _row(0, 0, 0, 0, 0, 0, 0, 0),
        _row(F(1, 10), 0, 0, 0, 0, 0, 0, 0),
        _row(F(-2, 81), F(20, 81), 0, 0, 0, 0, 0, 0),
        _row(F(615, 1372), F(-270, 343), F(1053, 1372), 0, 0, 0, 0, 0),
        _row(F(3243, 5500), F(-54, 55), F(50949, 71500), F(4998, 17875), 0, 0, 0, 0),
        _row(
            F(-26492, 37125),
            F(72, 55),
            F(2808, 23375),
            F(-24206, 37125),
            F(338, 459),
            0,
            0,
            0,
        ),
        _row(
            F(5561, 2376),
            F(-35, 11),
            F(-24117, 31603),
            F(899983, 200772),
            F(-5225, 1836),
            F(3925, 4056),
            0,
            0,
        ),
        _row(
            F(465467, 266112),
            F(-2945, 1232),
            F(-5610201, 14158144),
            F(10513573, 3212352),
            F(-424325, 205632),
            F(376225, 454272),
            0,
            0,
        ),
    ),
    b_sol=_row(
        F(61, 864),
        0,
        F(98415, 321776),
        F(16807, 146016),
        F(1375, 7344),
        F(1375, 5408),
        F(-37, 1120),
        F(1, 10),
    ),
    b_err=_row(
        F(821, 10800),
        0,
        F(19683, 71825),
        F(175273, 912600),
        F(395, 3672),
        F(785, 2704),
        F(3, 50),
        0,
    ),
    c=_row(0, F(1, 10), F(2, 9), F(3, 7), F(3, 5), F(4, 5), 1, 1),
)

TABLEAUS = {t.name: t for t in (HEUN_EULER, BS32, RKF45, DOPRI65)}
