"""DPM-Solver++(2M), the counterpart of chiaswarm_tpu/schedulers/solvers.py
`DPMSolverMultistepScheduler` (the reference's default scheduler).

Same interface: `schedule(n)` precomputes the per-step tables (numpy),
`loop_bounds`, `scale_model_input`, `init_state` and
`step(schedule, state, i, sample, model_output, noise)`. Here `i` is a
Python int, so the per-step constants are computed on the host in
float32, as the JAX package's traced f32 arithmetic computes them, and
only the latent update runs on the tensors. DPM++ 2M draws no per-step
noise: `noise` is accepted for the interface and ignored.
"""

from __future__ import annotations

import numpy as np

from .common import Schedule, SchedulerConfig, discrete_schedule


def _f32(x) -> np.float32:
    return np.float32(x)


def _abar(sigma: np.float32) -> np.float32:
    return _f32(1.0) / (_f32(1.0) + sigma * sigma)


def x0_from_vp_space(sample, model_output, abar, prediction_type: str):
    """x0 given a VP sample (x = sqrt(abar) x0 + sqrt(1-abar) eps) and an
    epsilon prediction (v-prediction comes with SD2.1-768's slice)."""
    if prediction_type != "epsilon":
        raise ValueError(f"prediction type {prediction_type!r} is not ported yet")
    sqrt_a, sqrt_1ma = float(np.sqrt(abar)), float(np.sqrt(_f32(1.0) - abar))
    return (sample - sqrt_1ma * model_output) / sqrt_a


class DPMSolverMultistepScheduler:
    """DPM-Solver++(2M), data prediction; first and final steps are first
    order (lower_order_final)."""

    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()

    def schedule(self, num_steps: int) -> Schedule:
        s = discrete_schedule(self.config, num_steps)
        return Schedule(s.timesteps, s.sigmas, 1.0, num_steps)

    def loop_bounds(self, schedule: Schedule, steps: int, t_start: int) -> tuple[int, int]:
        return t_start, steps

    def scale_model_input(self, schedule: Schedule, sample, i: int):
        return sample

    def init_state(self, sample):
        """(previous step's x0 prediction, has-history flag)."""
        return (None, False)

    def step(self, schedule: Schedule, state, i: int, sample, model_output, noise=None):
        sigmas = schedule.sigmas
        sig_t = _f32(sigmas[i])
        sig_next = max(_f32(sigmas[i + 1]), _f32(1e-5))
        sig_prev = _f32(sigmas[max(i - 1, 0)]) if i > 0 else sig_t

        abar_t = _abar(sig_t)
        x0 = x0_from_vp_space(sample, model_output, abar_t, self.config.prediction_type)

        h = -np.log(sig_next) + np.log(sig_t)
        h_last = -np.log(sig_t) + np.log(sig_prev)
        r = h_last / (h if h != 0 else _f32(1.0))
        if r == 0:
            r = _f32(1.0)

        x0_prev, has_history = state
        last = i == schedule.num_steps - 1
        if not has_history or last:
            d = x0
        else:
            half_inv_r = _f32(1.0) / (_f32(2.0) * r)
            d = float(_f32(1.0) + half_inv_r) * x0 - float(half_inv_r) * x0_prev

        alpha_next = np.sqrt(_abar(sig_next))
        sigma_vp_next = sig_next * alpha_next
        sigma_vp_t = sig_t * np.sqrt(abar_t)
        if last:
            new_sample = d  # exact final step: x0 (sigma -> 0)
        else:
            coef = alpha_next * (np.exp(-h) - _f32(1.0))
            new_sample = float(sigma_vp_next / sigma_vp_t) * sample - float(coef) * d
        return (x0, True), new_sample
