"""chiaswarm_tpu_torch: the swarm worker ported to PyTorch and CUDA.

A second package beside `chiaswarm_tpu` (the JAX reference, which it
imports nothing of). It serves SDXL txt2img jobs over the hive protocol
on an NVIDIA H100, with attention and GroupNorm in hand-written Hopper
kernels (`csrc/`). Entry points run on the card unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
