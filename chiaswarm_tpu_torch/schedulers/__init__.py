"""Diffusion schedulers by wire name. The port has DPM-Solver++(2M), the
reference's default; the other solvers of chiaswarm_tpu/schedulers wait
for their slice (ROADMAP.md)."""

from .common import Schedule, SchedulerConfig
from .solvers import DPMSolverMultistepScheduler

SCHEDULERS = {
    "DPMSolverMultistepScheduler": DPMSolverMultistepScheduler,
}


def get_scheduler(name: str, **config):
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"scheduler {name!r} is not ported to chiaswarm_tpu_torch yet "
            f"(available: {', '.join(SCHEDULERS)})") from None
    return cls(SchedulerConfig(**config))


__all__ = ["Schedule", "SchedulerConfig", "DPMSolverMultistepScheduler",
           "SCHEDULERS", "get_scheduler"]
