"""Diffusion schedulers by wire name: every SD solver of the JAX package's
registry (chiaswarm_tpu/schedulers/__init__.py), with its aliases, and
Flux's flow-matching Euler (`FlowMatchEulerScheduler`, also under
diffusers' name `FlowMatchEulerDiscreteScheduler`).

Stable Cascade's ratio-space DDPM comes with the family that uses it
(ROADMAP.md); asking for it raises, naming that slice, and an unknown
name raises as in the JAX package.
"""

from .common import Schedule, SchedulerConfig
from .solvers import (
    BaseScheduler,
    DDIMScheduler,
    DDPMScheduler,
    DPMSolverMultistepScheduler,
    EulerAncestralDiscreteScheduler,
    EulerDiscreteScheduler,
    FlowMatchEulerScheduler,
    HeunDiscreteScheduler,
    LCMScheduler,
    UniPCMultistepScheduler,
)

# wire name -> implementation, the aliases as in the JAX package
SCHEDULERS = {
    "DPMSolverMultistepScheduler": DPMSolverMultistepScheduler,
    "DPMSolverSinglestepScheduler": DPMSolverMultistepScheduler,
    "UniPCMultistepScheduler": UniPCMultistepScheduler,
    "EulerDiscreteScheduler": EulerDiscreteScheduler,
    "EulerAncestralDiscreteScheduler": EulerAncestralDiscreteScheduler,
    "DDIMScheduler": DDIMScheduler,
    "DDPMScheduler": DDPMScheduler,
    "PNDMScheduler": DDIMScheduler,
    "LMSDiscreteScheduler": EulerDiscreteScheduler,
    "HeunDiscreteScheduler": HeunDiscreteScheduler,
    "LCMScheduler": LCMScheduler,
    "FlowMatchEulerScheduler": FlowMatchEulerScheduler,
    "FlowMatchEulerDiscreteScheduler": FlowMatchEulerScheduler,
}

# wire names of the JAX registry whose solver comes with a later slice
LATER_SLICE = {
    "DDPMWuerstchenScheduler": "Stable Cascade",
}


def get_scheduler(name: str, **config):
    cls = SCHEDULERS.get(name)
    if cls is None:
        if name in LATER_SLICE:
            raise ValueError(
                f"scheduler {name!r} is not ported to chiaswarm_tpu_torch yet: it comes "
                f"with the {LATER_SLICE[name]} slice of the port")
        raise ValueError(f"Unknown scheduler type: {name}")
    return cls(SchedulerConfig(**config))


__all__ = [
    "Schedule", "SchedulerConfig", "SCHEDULERS", "LATER_SLICE", "get_scheduler",
    "BaseScheduler", "DDIMScheduler", "DDPMScheduler", "DPMSolverMultistepScheduler",
    "EulerAncestralDiscreteScheduler", "EulerDiscreteScheduler", "FlowMatchEulerScheduler",
    "HeunDiscreteScheduler",
    "LCMScheduler", "UniPCMultistepScheduler",
]
