"""The SD solvers, the counterparts of chiaswarm_tpu/schedulers/solvers.py.

Same interface: `schedule(n)` precomputes the per-step tables (numpy),
`loop_bounds`, `scale_model_input`, `init_state`, `add_noise` and
`step(schedule, state, i, sample, model_output, noise)`. Here `i` is a
Python int, so every per-step constant is computed on the host in
float32, in the order the JAX package's traced f32 arithmetic computes
it, and only the latent update runs on the tensors. Where the JAX step
selects with `jnp.where` on the step index or a history flag, this one
branches in Python: the state carries what the JAX state pytree carries,
with the flags as Python bools.

Two parametrisations, as in the JAX package:

- sigma space (Euler, Euler ancestral, Heun): x = x0 + sigma * eps, and
  the model input is rescaled by 1 / sqrt(sigma^2 + 1);
- VP space (DPM-Solver++ 2M, UniPC, DDIM, DDPM, LCM):
  x = sqrt(abar) x0 + sqrt(1 - abar) eps with abar = 1 / (1 + sigma^2).

`noise` is the step's fresh normal draw, which only solvers with
`uses_ancestral_noise` read; the others accept and ignore it.
"""

from __future__ import annotations

import numpy as np

from .common import Schedule, SchedulerConfig, ddpm_schedule, discrete_schedule, train_sigmas

_ONE = np.float32(1.0)


def _f32(x) -> np.float32:
    return np.float32(x)


def _abar(sigma: np.float32) -> np.float32:
    return _ONE / (_ONE + sigma * sigma)


# --- prediction-type conversions ---

def x0_from_sigma_space(sample, model_output, sigma: np.float32, prediction_type: str):
    """x0 given a sigma-space sample (x = x0 + sigma * eps)."""
    if prediction_type == "epsilon":
        return sample - float(sigma) * model_output
    if prediction_type == "v_prediction":
        s2 = sigma * sigma + _ONE
        return sample / float(s2) - model_output * float(sigma) / float(np.sqrt(s2))
    if prediction_type == "sample":
        return model_output
    raise ValueError(f"Unknown prediction type: {prediction_type}")


def x0_eps_from_vp_space(sample, model_output, abar: np.float32, prediction_type: str):
    """(x0, eps) given a VP sample (x = sqrt(abar) x0 + sqrt(1 - abar) eps)."""
    sqrt_a, sqrt_1ma = float(np.sqrt(abar)), float(np.sqrt(_ONE - abar))
    if prediction_type == "epsilon":
        eps = model_output
        x0 = (sample - sqrt_1ma * eps) / sqrt_a
    elif prediction_type == "v_prediction":
        x0 = sqrt_a * sample - sqrt_1ma * model_output
        eps = sqrt_a * model_output + sqrt_1ma * sample
    elif prediction_type == "sample":
        x0 = model_output
        eps = (sample - sqrt_a * x0) / max(sqrt_1ma, float(_f32(1e-8)))
    else:
        raise ValueError(f"Unknown prediction type: {prediction_type}")
    return x0, eps


class BaseScheduler:
    """A stateless solver bound to a SchedulerConfig."""

    uses_ancestral_noise = False

    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()

    def schedule(self, num_steps: int) -> Schedule:
        raise NotImplementedError

    def loop_bounds(self, schedule: Schedule, steps: int, t_start: int) -> tuple[int, int]:
        """(first, end) index of the denoise loop over this schedule: one
        model call per user step (Heun maps onto its doubled index space)."""
        return t_start, steps

    def scale_model_input(self, schedule: Schedule, sample, i: int):
        return sample

    def init_state(self, sample):
        return ()

    def step(self, schedule: Schedule, state, i: int, sample, model_output, noise=None):
        raise NotImplementedError

    def add_noise(self, schedule: Schedule, x0, noise, i: int):
        """Clean latents noised to step i's level (img2img and inpaint
        starts, inpaint's kept region). VP form; sigma space overrides."""
        abar = _abar(_f32(schedule.sigmas[i]))
        return float(np.sqrt(abar)) * x0 + float(np.sqrt(_ONE - abar)) * noise


# --- sigma-space solvers ---

class EulerDiscreteScheduler(BaseScheduler):
    def schedule(self, num_steps: int) -> Schedule:
        s = discrete_schedule(self.config, num_steps)
        # diffusers: 'leading' spacing scales the initial noise by
        # sqrt(sigma_max^2 + 1), linspace and trailing by sigma_max
        if self.config.timestep_spacing == "leading":
            init = float(np.sqrt(s.sigmas[0] ** 2 + 1.0))
        else:
            init = float(s.sigmas[0])
        return Schedule(s.timesteps, s.sigmas, init, num_steps)

    def scale_model_input(self, schedule: Schedule, sample, i: int):
        sigma = _f32(schedule.sigmas[i])
        return sample / float(np.sqrt(sigma * sigma + _ONE))

    def add_noise(self, schedule: Schedule, x0, noise, i: int):
        return x0 + float(_f32(schedule.sigmas[i])) * noise

    def _derivative(self, schedule: Schedule, i: int, sample, model_output):
        sigma = _f32(schedule.sigmas[i])
        x0 = x0_from_sigma_space(sample, model_output, sigma, self.config.prediction_type)
        return sigma, (sample - x0) / float(sigma)

    def step(self, schedule, state, i, sample, model_output, noise=None):
        sigma, derivative = self._derivative(schedule, i, sample, model_output)
        return state, sample + derivative * float(_f32(schedule.sigmas[i + 1]) - sigma)


class EulerAncestralDiscreteScheduler(EulerDiscreteScheduler):
    uses_ancestral_noise = True

    def step(self, schedule, state, i, sample, model_output, noise=None):
        sigma, derivative = self._derivative(schedule, i, sample, model_output)
        sigma_next = _f32(schedule.sigmas[i + 1])
        s2, n2 = sigma * sigma, sigma_next * sigma_next
        sigma_up = np.sqrt(max(n2 * (s2 - n2) / s2, _f32(0.0)))
        sigma_down = np.sqrt(max(n2 - sigma_up * sigma_up, _f32(0.0)))
        sample = sample + derivative * float(sigma_down - sigma)
        return state, sample + noise * float(sigma_up)


class HeunDiscreteScheduler(EulerDiscreteScheduler):
    """Heun's second-order method as an interleaved schedule, as in the JAX
    package: sigmas [s0, s1, s1, s2, s2, ..., 0] over 2N - 1 model calls;
    even indices take the Euler predictor, odd ones average the two
    slopes from the saved pre-step sample."""

    def schedule(self, num_steps: int) -> Schedule:
        base = super().schedule(num_steps)
        b = np.asarray(base.sigmas)[:-1]
        inter = np.concatenate([[b[0]], np.repeat(b[1:], 2), [0.0]]).astype(np.float32)
        ts = np.asarray(base.timesteps)
        ts_inter = np.concatenate([[ts[0]], np.repeat(ts[1:], 2)]).astype(np.float32)
        return Schedule(ts_inter, inter, base.init_noise_sigma, 2 * num_steps - 1)

    def loop_bounds(self, schedule, steps, t_start):
        # a start lands on an even (predictor) index
        return 2 * t_start, schedule.num_steps

    def init_state(self, sample):
        """(pre-step sample, predictor slope)."""
        return (sample.new_zeros(sample.shape), sample.new_zeros(sample.shape))

    def step(self, schedule, state, i, sample, model_output, noise=None):
        sigma, derivative = self._derivative(schedule, i, sample, model_output)
        if i % 2 == 0:
            pred_next = sample + derivative * float(_f32(schedule.sigmas[i + 1]) - sigma)
            return (sample, derivative), pred_next
        x_prev, d_prev = state
        dt_full = sigma - _f32(schedule.sigmas[max(i - 1, 0)])
        return state, x_prev + (0.5 * (d_prev + derivative)) * float(dt_full)


# --- VP-space solvers ---

def _log_steps(schedule: Schedule, i: int):
    """(sigma_t, sigma_next clamped for the log, sigma_prev, h, h_last)
    with lambda(s) = -log(s)."""
    sigmas = schedule.sigmas
    sig_t = _f32(sigmas[i])
    sig_next = max(_f32(sigmas[i + 1]), _f32(1e-5))
    sig_prev = _f32(sigmas[max(i - 1, 0)]) if i > 0 else sig_t
    h = -np.log(sig_next) - -np.log(sig_t)
    h_last = -np.log(sig_t) - -np.log(sig_prev)
    return sig_t, sig_next, sig_prev, h, h_last


def _multistep_d(x0, x0_prev, h, h_last, first_order: bool):
    """The 2M data term: x0 at a first-order step, else the two-point
    extrapolation from the previous x0."""
    if first_order:
        return x0
    r = h_last / (h if h != 0 else _ONE)
    half_inv_r = _ONE / (_f32(2.0) * (r if r != 0 else _ONE))
    return float(_ONE + half_inv_r) * x0 - float(half_inv_r) * x0_prev


def _vp_advance(sample, d, sig_t, sig_next, h):
    """The exponential-integrator step from sig_t to sig_next in VP space."""
    alpha_next = np.sqrt(_abar(sig_next))
    sigma_vp_next = sig_next * alpha_next
    sigma_vp_t = sig_t * np.sqrt(_abar(sig_t))
    coef = alpha_next * (np.exp(-h) - _ONE)
    return float(sigma_vp_next / sigma_vp_t) * sample - float(coef) * d


class DPMSolverMultistepScheduler(BaseScheduler):
    """DPM-Solver++(2M), data prediction, the reference's default; the
    first step after a start and the final step are first order
    (lower_order_final)."""

    def schedule(self, num_steps: int) -> Schedule:
        s = discrete_schedule(self.config, num_steps)
        return Schedule(s.timesteps, s.sigmas, 1.0, num_steps)

    def init_state(self, sample):
        """(previous step's x0, has-history flag). The flag, not i == 0,
        gates the second-order update: img2img starts at i = t_start."""
        return (None, False)

    def step(self, schedule, state, i, sample, model_output, noise=None):
        sig_t, sig_next, _, h, h_last = _log_steps(schedule, i)
        x0, _ = x0_eps_from_vp_space(sample, model_output, _abar(sig_t),
                                     self.config.prediction_type)
        x0_prev, has_history = state
        last = i == schedule.num_steps - 1
        d = _multistep_d(x0, x0_prev, h, h_last, not has_history or last)
        if last:
            return (x0, True), d  # exact final step: x0 (sigma -> 0)
        return (x0, True), _vp_advance(sample, d, sig_t, sig_next, h)


class UniPCMultistepScheduler(DPMSolverMultistepScheduler):
    """UniPC-style predictor-corrector of order 2 (the JAX package's form):
    each model output first corrects the sample it was evaluated at (the
    trapezoid of the previous and the new x0 from the saved pre-prediction
    sample), then the 2M predictor advances."""

    def init_state(self, sample):
        """(previous pre-prediction sample, previous x0, has-history)."""
        return (None, None, False)

    def step(self, schedule, state, i, sample, model_output, noise=None):
        sig_t, sig_next, sig_prev, h, h_last = _log_steps(schedule, i)
        abar_t = _abar(sig_t)
        x0, _ = x0_eps_from_vp_space(sample, model_output, abar_t,
                                     self.config.prediction_type)
        x_prev, x0_prev, has_history = state
        if has_history:
            h_last_safe = h_last if h_last != 0 else _ONE
            alpha_t = np.sqrt(abar_t)
            sigma_vp_t = sig_t * alpha_t
            sigma_vp_prev = sig_prev * np.sqrt(_abar(sig_prev))
            d_corr = 0.5 * (x0_prev + x0)
            coef = alpha_t * (np.exp(-h_last_safe) - _ONE)
            sample = float(sigma_vp_t / sigma_vp_prev) * x_prev - float(coef) * d_corr
        last = i == schedule.num_steps - 1
        d = _multistep_d(x0, x0_prev, h, h_last, not has_history or last)
        if last:
            return (sample, x0, True), d
        return (sample, x0, True), _vp_advance(sample, d, sig_t, sig_next, h)


class DDIMScheduler(BaseScheduler):
    def schedule(self, num_steps: int) -> Schedule:
        return ddpm_schedule(self.config, num_steps)

    def step(self, schedule, state, i, sample, model_output, noise=None):
        abar_t, abar_next = _abar(_f32(schedule.sigmas[i])), _abar(_f32(schedule.sigmas[i + 1]))
        x0, eps = x0_eps_from_vp_space(sample, model_output, abar_t,
                                       self.config.prediction_type)
        return state, (float(np.sqrt(abar_next)) * x0
                       + float(np.sqrt(_ONE - abar_next)) * eps)


class DDPMScheduler(BaseScheduler):
    uses_ancestral_noise = True

    def schedule(self, num_steps: int) -> Schedule:
        return ddpm_schedule(self.config, num_steps)

    def step(self, schedule, state, i, sample, model_output, noise=None):
        abar_t, abar_next = _abar(_f32(schedule.sigmas[i])), _abar(_f32(schedule.sigmas[i + 1]))
        x0, _ = x0_eps_from_vp_space(sample, model_output, abar_t,
                                     self.config.prediction_type)
        if i == schedule.num_steps - 1:
            return state, x0
        alpha_t = abar_t / abar_next  # the step's own alpha
        beta_t = _ONE - alpha_t
        # posterior mean (DDPM eq. 7) and variance
        c_x0 = np.sqrt(abar_next) * beta_t / (_ONE - abar_t)
        c_x = np.sqrt(alpha_t) * (_ONE - abar_next) / (_ONE - abar_t)
        var = beta_t * (_ONE - abar_next) / (_ONE - abar_t)
        mean = float(c_x0) * x0 + float(c_x) * sample
        return state, mean + float(np.sqrt(max(var, _f32(1e-20)))) * noise


class LCMScheduler(BaseScheduler):
    """Latent-consistency sampling: x0 through the boundary-condition
    scaling, fresh noise between the few steps."""

    uses_ancestral_noise = True

    def schedule(self, num_steps: int) -> Schedule:
        # LCM picks its k timesteps from the teacher's original step grid
        cfg = self.config
        n = cfg.num_train_timesteps
        k = n // cfg.original_inference_steps
        origin = np.arange(1, cfg.original_inference_steps + 1) * k - 1
        idx = np.linspace(0, len(origin) - 1, num_steps).round().astype(int)
        ts = origin[idx][::-1].astype(np.float64)
        sigmas = np.interp(ts, np.arange(n), train_sigmas(cfg))
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return Schedule(ts.astype(np.float32), sigmas, 1.0, num_steps)

    def step(self, schedule, state, i, sample, model_output, noise=None):
        abar_t, abar_next = _abar(_f32(schedule.sigmas[i])), _abar(_f32(schedule.sigmas[i + 1]))
        x0, _ = x0_eps_from_vp_space(sample, model_output, abar_t,
                                     self.config.prediction_type)
        # consistency boundary conditions (sigma_data 0.5, timestep scaling 10)
        scaled_t = _f32(schedule.timesteps[i]) * _f32(10.0)
        quarter = _f32(0.25)
        c_skip = quarter / (scaled_t * scaled_t + quarter)
        c_out = scaled_t / np.sqrt(scaled_t * scaled_t + quarter)
        denoised = float(c_skip) * sample + float(c_out) * x0
        if i == schedule.num_steps - 1:
            return state, denoised
        return state, (float(np.sqrt(abar_next)) * denoised
                       + float(np.sqrt(_ONE - abar_next)) * noise)
