"""Diffusion schedulers by wire name: every solver of the JAX package's
registry (chiaswarm_tpu/schedulers/__init__.py), with its aliases: the SD
solvers, Flux's flow-matching Euler (`FlowMatchEulerScheduler`, also under
diffusers' name `FlowMatchEulerDiscreteScheduler`) and Stable Cascade's
ratio-space DDPM (`DDPMWuerstchenScheduler`). An unknown name raises as in
the JAX package.
"""

from .common import Schedule, SchedulerConfig
from .solvers import (
    BaseScheduler,
    DDIMScheduler,
    DDPMScheduler,
    DDPMWuerstchenScheduler,
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
    "DDPMWuerstchenScheduler": DDPMWuerstchenScheduler,
    "PNDMScheduler": DDIMScheduler,
    "LMSDiscreteScheduler": EulerDiscreteScheduler,
    "HeunDiscreteScheduler": HeunDiscreteScheduler,
    "LCMScheduler": LCMScheduler,
    "FlowMatchEulerScheduler": FlowMatchEulerScheduler,
    "FlowMatchEulerDiscreteScheduler": FlowMatchEulerScheduler,
}

def get_scheduler(name: str, **config):
    cls = SCHEDULERS.get(name)
    if cls is None:
        raise ValueError(f"Unknown scheduler type: {name}")
    return cls(SchedulerConfig(**config))


__all__ = [
    "Schedule", "SchedulerConfig", "SCHEDULERS", "get_scheduler",
    "BaseScheduler", "DDIMScheduler", "DDPMScheduler", "DDPMWuerstchenScheduler",
    "DPMSolverMultistepScheduler",
    "EulerAncestralDiscreteScheduler", "EulerDiscreteScheduler", "FlowMatchEulerScheduler",
    "HeunDiscreteScheduler",
    "LCMScheduler", "UniPCMultistepScheduler",
]
