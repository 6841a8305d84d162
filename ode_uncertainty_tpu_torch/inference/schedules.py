"""Process-noise tempering schedules (port of
``ode_uncertainty_tpu/inference/schedules.py``).

gamma(idx) gives the process-noise magnitude at tempering stage idx;
``gammas(num_stages, final_zero)`` returns the whole stage vector, computed
in float64 on the host (callers cast it to their dtype).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    init_noise_log: float = 0.0

    def gamma(self, idx):
        raise NotImplementedError

    def gammas(self, num_stages: int, final_zero: bool = True) -> torch.Tensor:
        """Stage vector [num_stages] (float64, CPU); optionally zero at the last stage."""
        g = torch.as_tensor(self.gamma(np.arange(num_stages, dtype=np.float64)), dtype=torch.float64)
        if final_zero and num_stages > 0:
            g[-1] = 0.0
        return g


@dataclasses.dataclass(frozen=True)
class LinearDecaySchedule(NoiseSchedule):
    """log10-linear decay: gamma = 10^(init - idx * rate)."""

    decay_rate: float = 1.0

    def gamma(self, idx):
        return np.power(10.0, self.init_noise_log - idx * self.decay_rate)


@dataclasses.dataclass(frozen=True)
class ExponentialDecaySchedule(NoiseSchedule):
    """Power-law decay: gamma = 10^init / (idx + 1)^rate."""

    decay_rate: float = 8.0

    def gamma(self, idx):
        return np.power(10.0, self.init_noise_log - self.decay_rate * np.log10(idx + 1.0))


@dataclasses.dataclass(frozen=True)
class CosineAnnealingSchedule(NoiseSchedule):
    """Cosine annealing between init and min log-noise, cyclic."""

    min_noise_log: float = -10.0
    cycle_length: int = 4

    def gamma(self, idx):
        idx_in_cycle = np.mod(idx, self.cycle_length)
        frac = idx_in_cycle / (self.cycle_length - 1)
        log_g = self.min_noise_log + 0.5 * (self.init_noise_log - self.min_noise_log) * (
            1.0 + np.cos(frac * np.pi)
        )
        return np.power(10.0, log_g)


SCHEDULE_REGISTRY = {
    "LinearDecaySchedule": LinearDecaySchedule,
    "ExponentialDecaySchedule": ExponentialDecaySchedule,
    "CosineAnnealingSchedule": CosineAnnealingSchedule,
}
