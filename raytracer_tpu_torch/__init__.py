"""raytracer_tpu_torch — the wavefront ray tracer in PyTorch and CUDA.

A port of the JAX/Pallas package `raytracer_tpu` (which stays the
reference) for one NVIDIA H100. It imports torch and numpy, never jax.
The tracers are hand-written CUDA kernels for CUDA tensors (csrc/:
cluster_trace.cu for single-level scenes; iseg_trace.cu and
icluster_trace.cu for instanced scenes of shallow and deep prototypes;
mt_trace.cu for the brute-force sweep; bvh_trace.cu for scenes built with
bvh=True and intersector 'bvh') and their plain PyTorch versions (ops/)
for CPU tensors; scenes with alpha maps wrap the cluster tracers in the
alpha march (ops/cluster_trace.alpha_aware_trace). `python -m
raytracer_tpu_torch.cli` renders a registry scene to a file.
"""

from .core.types import Camera, RenderSettings, Scene, MAT_BLINN, MAT_LAMBERT
from .geometry.build import SceneBuilder
from .render.renderer import render, render_adaptive, render_center, to_u8

__version__ = '0.1.0'
