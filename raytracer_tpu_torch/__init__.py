"""raytracer_tpu_torch — the wavefront ray tracer in PyTorch and CUDA.

A port of the JAX/Pallas package `raytracer_tpu` (which stays the
reference) for one NVIDIA H100. It imports torch and numpy, never jax.
The cluster tracer is a hand-written CUDA kernel (csrc/cluster_trace.cu)
for CUDA tensors and its plain PyTorch version for CPU tensors.
"""

from .core.types import Camera, RenderSettings, Scene, MAT_BLINN, MAT_LAMBERT
from .geometry.build import SceneBuilder
from .render.renderer import render, render_adaptive, render_center, to_u8

__version__ = '0.1.0'
