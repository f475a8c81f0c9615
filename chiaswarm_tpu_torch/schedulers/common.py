"""Shared scheduler machinery: beta schedules, sigma tables, Karras spacing.

A copy of chiaswarm_tpu/schedulers/common.py (the port imports nothing of
the JAX package). All functions are host-side (numpy): a schedule is
computed once per (scheduler, step count); only `step()` touches tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"  # epsilon | v_prediction | sample | flow
    use_karras_sigmas: bool = False
    timestep_spacing: str = "leading"  # leading | trailing | linspace
    steps_offset: int = 1
    # LCM distillation params
    original_inference_steps: int = 50
    # flow-matching (Flux) params
    shift: float = 3.0

    def replace(self, **kw) -> "SchedulerConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed per-step constants for one (scheduler, num_steps) pair.

    Arrays are length num_steps (+1 where a terminal boundary is needed);
    `step()` indexes them with the scan counter.
    """

    timesteps: np.ndarray  # model-conditioning timesteps, float32 [n]
    sigmas: np.ndarray  # noise levels incl. terminal 0, float32 [n+1]
    init_noise_sigma: float  # latent init scale
    num_steps: int


def make_betas(config: SchedulerConfig) -> np.ndarray:
    n = config.num_train_timesteps
    if config.beta_schedule == "linear":
        return np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    if config.beta_schedule == "scaled_linear":
        return (
            np.linspace(config.beta_start**0.5, config.beta_end**0.5, n, dtype=np.float64)
            ** 2
        )
    if config.beta_schedule == "squaredcos_cap_v2":
        t = np.arange(n, dtype=np.float64)
        f = lambda x: np.cos((x / n + 0.008) / 1.008 * np.pi / 2) ** 2
        return np.clip(1.0 - f(t + 1) / f(t), 0.0, 0.999)
    raise ValueError(f"Unknown beta schedule: {config.beta_schedule}")


def make_alphas_cumprod(config: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(config))


def train_sigmas(config: SchedulerConfig) -> np.ndarray:
    """sigma(t) table over all train timesteps: sqrt((1-a)/a)."""
    ac = make_alphas_cumprod(config)
    return np.sqrt((1.0 - ac) / ac)


def spaced_timesteps(config: SchedulerConfig, num_steps: int) -> np.ndarray:
    """Inference timestep selection (descending), diffusers-compatible."""
    n = config.num_train_timesteps
    if config.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_steps)[::-1]
    elif config.timestep_spacing == "leading":
        step = n // num_steps
        ts = (np.arange(num_steps) * step)[::-1].astype(np.float64)
        ts = ts + config.steps_offset
    elif config.timestep_spacing == "trailing":
        ts = np.arange(n, 0, -n / num_steps).round().astype(np.float64) - 1
    else:
        raise ValueError(f"Unknown timestep spacing: {config.timestep_spacing}")
    return np.clip(ts, 0, n - 1).astype(np.float64)


def karras_sigmas(sigma_min: float, sigma_max: float, num_steps: int, rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) sigma spacing, descending."""
    ramp = np.linspace(0, 1, num_steps)
    min_inv, max_inv = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return (max_inv + ramp * (min_inv - max_inv)) ** rho


def sigma_to_timestep(sigmas: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Map sigmas back to (fractional) train timesteps by log-interpolation."""
    log_table = np.log(np.maximum(table, 1e-10))
    log_s = np.log(np.maximum(sigmas, 1e-10))
    # table is increasing in t
    return np.interp(log_s, log_table, np.arange(len(table), dtype=np.float64))


def discrete_schedule(config: SchedulerConfig, num_steps: int) -> Schedule:
    """Sigma schedule for k-diffusion style solvers (Euler/DPM++), with the
    Karras option the reference toggles per-job."""
    table = train_sigmas(config)
    ts = spaced_timesteps(config, num_steps)
    sigmas = np.interp(ts, np.arange(len(table)), table)
    if config.use_karras_sigmas:
        sigmas = karras_sigmas(float(sigmas[-1]), float(sigmas[0]), num_steps)
        ts = sigma_to_timestep(sigmas, table)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return Schedule(
        timesteps=ts.astype(np.float32),
        sigmas=sigmas,
        init_noise_sigma=float(np.sqrt(sigmas[0] ** 2 + 1.0)),
        num_steps=num_steps,
    )


def ddpm_schedule(config: SchedulerConfig, num_steps: int) -> Schedule:
    """Alpha-bar schedule for variance-preserving solvers (DDIM/DDPM/LCM).

    `sigmas` here stores sqrt(1-abar)/sqrt(abar) for interface uniformity;
    solvers that need abar recover it as 1/(1+sigma^2).
    """
    table = train_sigmas(config)
    ts = spaced_timesteps(config, num_steps)
    sigmas = np.interp(ts, np.arange(len(table)), table)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return Schedule(
        timesteps=ts.astype(np.float32),
        sigmas=sigmas,
        init_noise_sigma=1.0,
        num_steps=num_steps,
    )
