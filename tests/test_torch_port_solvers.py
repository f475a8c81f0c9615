"""chiaswarm_tpu_torch's SD solvers against the JAX package's, on the CPU.

Every ported solver runs whole schedules of 1, 4 and 30 steps for both
prediction types, with and without Karras sigmas: the schedule tables
must be equal, and `scale_model_input` and `step` must agree on the same
sample, model output and (for the ancestral solvers) numpy noise at every
index. `add_noise` is compared at several indices, and `loop_bounds` with
t_start > 0 (Heun's doubled index space included), followed by the loop
an img2img job runs from that start. The wire-name registry must map
every SD name of the JAX registry onto the same solver.

Tolerance: 1e-5 absolute and relative, as test_dpm_solver_step_matches_jax:
both sides compute the step constants in f32 and the update elementwise
in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.schedulers import SCHEDULERS as JAX_SCHEDULERS
from chiaswarm_tpu.schedulers import get_scheduler as jax_get_scheduler
from chiaswarm_tpu_torch.schedulers import LATER_SLICE, SCHEDULERS, get_scheduler

TOL = dict(atol=1e-5, rtol=1e-5)
SOLVERS = ["DPMSolverMultistepScheduler", "UniPCMultistepScheduler", "EulerDiscreteScheduler",
           "EulerAncestralDiscreteScheduler", "HeunDiscreteScheduler", "DDIMScheduler",
           "DDPMScheduler", "LCMScheduler"]
SHAPE = (1, 8, 8, 4)


def _pair(name, **config):
    return jax_get_scheduler(name, **config), get_scheduler(name, **config)


def _run_loop(jax_sched, sched, jax_schedule, schedule, start, end, sample, rng, what):
    """Both solvers from the same sample over [start, end): model outputs
    and noise drawn from rng, results compared at every index."""
    jax_state = jax_sched.init_state(sample.shape, jnp.float32)
    jax_sample = jnp.asarray(sample)
    port_sample = torch.from_numpy(sample)
    state = sched.init_state(port_sample)
    for i in range(start, end):
        np.testing.assert_allclose(
            sched.scale_model_input(schedule, port_sample, i).numpy(),
            np.asarray(jax_sched.scale_model_input(jax_schedule, jax_sample, i)),
            **TOL, err_msg=f"{what}: scale_model_input {i}")
        out = rng.standard_normal(sample.shape).astype(np.float32)
        noise = rng.standard_normal(sample.shape).astype(np.float32)
        jax_state, jax_sample = jax_sched.step(jax_schedule, jax_state, i, jax_sample,
                                               jnp.asarray(out), jnp.asarray(noise))
        state, port_sample = sched.step(schedule, state, i, port_sample,
                                        torch.from_numpy(out), torch.from_numpy(noise))
        np.testing.assert_allclose(port_sample.numpy(), np.asarray(jax_sample), **TOL,
                                   err_msg=f"{what}: step {i}")
    return port_sample.numpy()


@pytest.mark.parametrize("karras", [False, True], ids=["plain", "karras"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("steps", [1, 4, 30])
@pytest.mark.parametrize("name", SOLVERS)
def test_solver_matches_jax(name, steps, prediction_type, karras):
    jax_sched, sched = _pair(name, prediction_type=prediction_type, use_karras_sigmas=karras)
    jax_schedule, schedule = jax_sched.schedule(steps), sched.schedule(steps)
    np.testing.assert_array_equal(schedule.sigmas, jax_schedule.sigmas)
    np.testing.assert_array_equal(schedule.timesteps, jax_schedule.timesteps)
    assert schedule.init_noise_sigma == jax_schedule.init_noise_sigma
    assert schedule.num_steps == jax_schedule.num_steps
    assert sched.uses_ancestral_noise == jax_sched.uses_ancestral_noise
    start, end = sched.loop_bounds(schedule, steps, 0)
    assert (start, end) == jax_sched.loop_bounds(jax_schedule, steps, 0)
    rng = np.random.default_rng(steps)
    sample = (rng.standard_normal(SHAPE) * schedule.init_noise_sigma).astype(np.float32)
    _run_loop(jax_sched, sched, jax_schedule, schedule, start, end, sample, rng,
              f"{name} {steps} {prediction_type} karras={karras}")


@pytest.mark.parametrize("name", SOLVERS)
def test_add_noise_and_img2img_start_match_jax(name):
    """add_noise at several indices; loop_bounds at t_start > 0; then the
    loop an img2img job runs from the noised start (a multistep solver's
    first step there has no history)."""
    steps = 30
    jax_sched, sched = _pair(name)
    jax_schedule, schedule = jax_sched.schedule(steps), sched.schedule(steps)
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal(SHAPE).astype(np.float32)
    noise = rng.standard_normal(SHAPE).astype(np.float32)
    for i in sorted({0, 1, 7, schedule.num_steps // 2, schedule.num_steps - 1}):
        np.testing.assert_allclose(
            sched.add_noise(schedule, torch.from_numpy(x0), torch.from_numpy(noise), i).numpy(),
            np.asarray(jax_sched.add_noise(jax_schedule, jnp.asarray(x0), jnp.asarray(noise), i)),
            **TOL, err_msg=f"add_noise {i}")
    for t_start in (0, 7, 22, steps - 1):
        bounds = sched.loop_bounds(schedule, steps, t_start)
        assert bounds == jax_sched.loop_bounds(jax_schedule, steps, t_start)
    start, end = sched.loop_bounds(schedule, steps, 7)
    assert (start, end) == ((14, 59) if name == "HeunDiscreteScheduler" else (7, 30))
    sample = np.array(jax_sched.add_noise(jax_schedule, jnp.asarray(x0), jnp.asarray(noise),
                                          start), np.float32)
    _run_loop(jax_sched, sched, jax_schedule, schedule, start, end, sample, rng,
              f"{name} from t_start 7")


def test_registry_covers_every_sd_wire_name():
    for wire, jax_cls in JAX_SCHEDULERS.items():
        if wire in LATER_SLICE:
            with pytest.raises(ValueError, match=LATER_SLICE[wire]):
                get_scheduler(wire)
            continue
        assert SCHEDULERS[wire].__name__ == jax_cls.__name__, wire
        assert type(get_scheduler(wire)).__name__ == jax_cls.__name__
    assert set(SCHEDULERS) | set(LATER_SLICE) == set(JAX_SCHEDULERS)
    with pytest.raises(ValueError, match="Unknown scheduler type"):
        get_scheduler("NoSuchScheduler")
