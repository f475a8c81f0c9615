"""chiaswarm_tpu_torch's scheduler and txt2img slice against the JAX package.

- DPM-Solver++(2M) `step` against the JAX `step` on identical state,
  sample and model output over a whole schedule (f32; tolerance 1e-5:
  both compute the step constants in f32 and the update elementwise).
- The slice: `SDPipeline("test/tiny-xl")` in JAX and in the port with the
  same weights and the initial latents that JAX drew, injected into the
  port. The JAX pipeline reads the port's random weights from safetensors
  under a temporary model root (its own loading path); the port pipeline
  loads what JAX holds through `weights.from_jax_params`. The decoded
  uint8 images must agree within 2/255 (f32 on both sides; rounding to
  uint8 can flip a pixel by one level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaswarm_tpu.schedulers import get_scheduler as jax_get_scheduler
from chiaswarm_tpu_torch.pipelines.stable_diffusion import SDPipeline
from chiaswarm_tpu_torch.schedulers import get_scheduler
from chiaswarm_tpu_torch.weights import from_jax_params


@pytest.mark.parametrize("steps", [1, 4, 30])
def test_dpm_solver_step_matches_jax(steps):
    jax_sched = jax_get_scheduler("DPMSolverMultistepScheduler")
    sched = get_scheduler("DPMSolverMultistepScheduler")
    jax_schedule, schedule = jax_sched.schedule(steps), sched.schedule(steps)
    np.testing.assert_array_equal(schedule.sigmas, jax_schedule.sigmas)
    np.testing.assert_array_equal(schedule.timesteps, jax_schedule.timesteps)
    rng = np.random.default_rng(steps)
    sample = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    jax_state = jax_sched.init_state(sample.shape, jnp.float32)
    jax_sample = jnp.asarray(sample)
    port_sample = torch.from_numpy(sample)
    state = sched.init_state(port_sample)
    for i in range(steps):
        out = rng.standard_normal(sample.shape).astype(np.float32)
        jax_state, jax_sample = jax_sched.step(
            jax_schedule, jax_state, i, jax_sample, jnp.asarray(out), None)
        state, port_sample = sched.step(schedule, state, i, port_sample, torch.from_numpy(out))
        np.testing.assert_allclose(port_sample.numpy(), np.asarray(jax_sample),
                                   atol=1e-5, rtol=1e-5, err_msg=f"step {i}")


def _save_safetensors(pipe, root):
    from safetensors.numpy import save_file

    parts = {"unet": pipe.unet, "vae": pipe.vae, "text_encoder": pipe.text_encoders[0],
             "text_encoder_2": pipe.text_encoders[1]}
    for sub, module in parts.items():
        (root / sub).mkdir(parents=True)
        save_file({k: v.detach().numpy().copy() for k, v in module.state_dict().items()},
                  str(root / sub / "model.safetensors"))


def test_tiny_xl_slice_matches_jax(sdaas_root, tmp_path, monkeypatch):
    from chiaswarm_tpu.pipelines.stable_diffusion import SDPipeline as JaxSDPipeline

    seeded = SDPipeline("test/tiny-xl", device="cpu")
    _save_safetensors(seeded, tmp_path / "models" / "test" / "tiny-xl")
    monkeypatch.setenv("CHIASWARM_MODEL_ROOT_DIR", str(tmp_path / "models"))
    reference = JaxSDPipeline("test/tiny-xl")

    params = jax.tree_util.tree_map(np.asarray, reference.params)
    port = SDPipeline("test/tiny-xl", device="cpu", weights=from_jax_params(params))

    seed, size, steps = 11, 64, 4
    job = dict(prompt="a red cube on a table", negative_prompt="blurry",
               num_inference_steps=steps, height=size, width=size, guidance_scale=6.0)
    want, _ = reference.run(rng=jax.random.key(seed), **job)
    # the JAX pipeline's draw: split(rng, 3) -> init_rng -> NHWC normal
    _, init_rng, _ = jax.random.split(jax.random.key(seed), 3)
    noise = np.asarray(jax.random.normal(init_rng, (1, size // 2, size // 2, 4), jnp.float32))
    got, config = port.run(latents=noise.transpose(0, 3, 1, 2), **job)

    assert config["latents"]["finite"]
    want = np.asarray(want[0], np.int16)
    got = np.asarray(got[0], np.int16)
    assert got.shape == want.shape == (size, size, 3)
    assert np.abs(got - want).max() <= 2
