"""Scene representation: dataclasses of tensors.

Port of raytracer_tpu/core/types.py. Tensor fields are the scene's arrays
(the JAX package's pytree leaves); the static flags that the JAX package
marks pytree_node=False stay Python values here. Every dataclass moves to a
device with an explicit `.to(device)`.

Left out on purpose: `Materials.kt` and `RenderSettings.num_paths` (nothing
reads them) and `RenderSettings.remat` (a JAX-only checkpointing switch).
A two-level scene carries its instance table and its instanced cluster
tables (geometry/clusters.InstancedClusters), and the cluster table of its
motion-blurred world triangles. Both kinds carry the edge table of
diff/edges.py unless an instanced scene has too many (instance, edge)
pairs. A scene built with `bvh=True` also carries the merged wide BVH
(`Scene.blas`, `bvh_root`) and its instances' BLAS roots (`Instances.root`),
which ops/traverse.bvh_trace walks.

Scene builders (geometry/build.SceneBuilder.build, scenes/registry,
convert) put their tensors on the card unless the caller names another
device: `device_of` resolves their `device=` argument, whose default is
CUDA, and raises when no card is present.

`.to(device)` keeps tensors that alias each other aliased: a static
cluster table's t = 1 pose tables are its t = 0 tables, as in the JAX
build, and stay one buffer on the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


CUDA = torch.device('cuda')


def device_of(device) -> torch.device:
    """The device a builder puts its scene on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: scenes are built on the card by default; pass "
            "device='cpu' to build on the CPU")
    return dev


class TensorData:
    """Mixin: `.to(device)` maps over tensor and nested TensorData fields;
    a tensor met twice is moved once."""

    def to(self, device, _memo=None):
        memo = {} if _memo is None else _memo
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, TensorData):
                v = v.to(device, memo)
            elif isinstance(v, torch.Tensor):
                if id(v) not in memo:
                    memo[id(v)] = v.to(device)
                v = memo[id(v)]
            kw[f.name] = v
        return type(self)(**kw)


@dataclass
class Geometry(TensorData):
    """Triangle soup over shared vertex pools (src/TriangleMesh.h:8-62).
    Motion blur is per triangle: vertices_t1 is the t = 1 pose (equal to
    vertices for static geometry) and intersection lerps by ray time."""
    vertices: torch.Tensor      # (V, 3) f32
    vertices_t1: torch.Tensor   # (V, 3) f32
    normals: torch.Tensor       # (N, 3) f32
    texcoords: torch.Tensor     # (U, 2) f32
    tangents: torch.Tensor      # (N, 3) f32
    bitangents: torch.Tensor    # (N, 3) f32
    face_v: torch.Tensor        # (T, 3) i32
    face_n: torch.Tensor        # (T, 3) i32
    face_t: torch.Tensor        # (T, 3) i32
    face_mat: torch.Tensor      # (T,) i32
    face_has_uv: torch.Tensor   # (T,) bool
    face_mb: torch.Tensor       # (T,) bool, motion-blurred triangle

    @property
    def num_tris(self) -> int:
        return self.face_v.shape[0]


MAT_LAMBERT = 0
MAT_BLINN = 1


@dataclass
class Materials(TensorData):
    """SoA material table (src/Material.h, src/Blinn.h)."""
    kind: torch.Tensor          # (M,) i32
    kd: torch.Tensor            # (M, 3)
    ka: torch.Tensor            # (M, 3)
    ks: torch.Tensor            # (M, 3)
    ior: torch.Tensor           # (M, 3)
    spec_exp: torch.Tensor      # (M,)
    spec_amt: torch.Tensor
    reflect_amt: torch.Tensor
    refract_amt: torch.Tensor
    spec_gloss: torch.Tensor
    translucency: torch.Tensor
    emitted_power: torch.Tensor
    le: torch.Tensor            # (M, 3)
    disperse: torch.Tensor      # (M,) bool
    sample_env: torch.Tensor    # (M,) bool
    env_exposure: torch.Tensor
    tex_color: torch.Tensor     # (M,) i32 texture id or -1
    tex_alpha: torch.Tensor
    tex_normal: torch.Tensor
    tex_spec: torch.Tensor
    tex_reflect: torch.Tensor
    tex_refract: torch.Tensor
    tex_env: torch.Tensor


@dataclass
class TexturePack(TensorData):
    """All textures flattened into one texel pool; rows are
    (offset, width, height, channels)."""
    data: torch.Tensor          # (D,) f32
    offset: torch.Tensor        # (K,) i32
    width: torch.Tensor
    height: torch.Tensor
    channels: torch.Tensor


@dataclass
class PointLights(TensorData):
    """src/PointLight.{h,cpp}."""
    position: torch.Tensor      # (L, 3)
    power: torch.Tensor         # (L,)
    color: torch.Tensor         # (L, 3)
    cast_shadows: tuple = ()
    fast_shadows: tuple = ()


@dataclass
class RectLights(TensorData):
    """Parallelogram area light (src/RectangleLight.{h,cpp}); `power` is the
    raw wattage, normalised by area at sample time."""
    v1: torch.Tensor            # (L, 3)
    v2: torch.Tensor
    v3: torch.Tensor
    power: torch.Tensor         # (L,)
    color: torch.Tensor         # (L, 3)
    cast_shadows: tuple = ()
    fast_shadows: tuple = ()
    num_samples: int = 1


@dataclass
class DomeLight(TensorData):
    """HDR environment dome with 2-D CDF importance sampling
    (src/DomeLight.{h,cpp}); the tables are built on the host from the
    lat-long texture `tex`."""
    gain: torch.Tensor          # () f32
    u_cdf: torch.Tensor         # (nu + 1,)
    u_func: torch.Tensor        # (nu,)
    u_func_int: torch.Tensor    # ()
    v_cdf: torch.Tensor         # (nu, nv + 1)
    v_func: torch.Tensor        # (nu, nv)
    v_func_int: torch.Tensor    # (nu,)
    tex: int = -1
    cast_shadows: bool = True
    fast_shadows: bool = True
    num_samples: int = 1


@dataclass
class BVHArrays(TensorData):
    """Flattened wide BVH (reference QBVH: src/BVH.h:66-109,
    src/BVH.cpp:100-389), as raytracer_tpu/core/types.py:BVHArrays.

    Node i has up to B children; child c covers the box
    [node_min[i, c], node_max[i, c]]:
      count[i, c] == 0  -> internal child, child[i, c] = child node id
      count[i, c] >  0  -> triangle leaf: `count` triangles at
                           prim_order[child[i, c]:]
      count[i, c] == -1 -> empty slot
      count[i, c] <= -2 -> instance leaf: -(count + 1) instance ids at
                           prim_order[child[i, c]:] (the TLAS section)
    The BLAS subtrees and the TLAS share one merged node pool, so a trace
    is one loop over it (geometry/bvh.build_scene_bvh)."""
    node_min: torch.Tensor      # (N, B, 3) f32
    node_max: torch.Tensor      # (N, B, 3) f32
    child: torch.Tensor         # (N, B) i32
    count: torch.Tensor         # (N, B) i32
    prim_order: torch.Tensor    # (T,) i32
    # the traversal's stack bound: the deepest BLAS plus the TLAS
    depth: int = 64


@dataclass
class Instances(TensorData):
    """Instance table (src/ProxyObject.h:11-35): m maps object -> world;
    rays go world -> object through m_inv (src/ProxyObject.cpp:76-95);
    normals are fixed up by m_inv_t (src/Ray.cpp:27-31). `root` is each
    instance's BLAS root in the merged BVH, None without one."""
    m: torch.Tensor             # (I, 3, 4) f32
    m_inv: torch.Tensor         # (I, 3, 4) f32
    m_inv_t: torch.Tensor       # (I, 3, 3) f32
    tri_lo: torch.Tensor        # (I,) i32 triangle id range of the prototype
    tri_hi: torch.Tensor        # (I,) i32
    root: Optional[torch.Tensor] = None   # (I,) i32 BLAS root node id


@dataclass
class EdgeTable(TensorData):
    """Unique mesh edges with their adjacent faces, for silhouette-edge
    sampling (diff/edges.py). An instanced scene also enumerates its
    (instance, edge) pairs: each prototype edge once per instance."""
    vid: torch.Tensor           # (E, 2) i32 endpoint vertex ids
    fid: torch.Tensor           # (E, 2) i32 adjacent faces, -1 = open edge
    pair_inst: Optional[torch.Tensor] = None   # (P,) i32 instance row
    pair_edge: Optional[torch.Tensor] = None   # (P,) i32 edge id


EPS_SHUTTER = 1e-3  # reference Camera ctor m_shutterSpeed = epsilon


@dataclass
class Camera(TensorData):
    """Thin-lens camera (src/Camera.h:9-76); fov in degrees."""
    eye: torch.Tensor           # (3,)
    view_dir: torch.Tensor      # (3,)
    up: torch.Tensor            # (3,)
    fov: torch.Tensor           # ()
    focus_plane: torch.Tensor   # ()
    aperture: torch.Tensor      # ()
    shutter: torch.Tensor       # ()

    @classmethod
    def make(cls, eye, look_at=None, view_dir=None, up=(0.0, 1.0, 0.0),
             fov=45.0, focus_plane=1.0, aperture=0.0, shutter=EPS_SHUTTER):
        eye = np.asarray(eye, np.float32)
        if view_dir is None:
            view_dir = np.asarray(look_at, np.float32) - eye
        view_dir = np.asarray(view_dir, np.float32)
        view_dir = view_dir / np.linalg.norm(view_dir)
        up = np.asarray(up, np.float32)
        up = up / np.linalg.norm(up)
        f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        return cls(eye=f(eye), view_dir=f(view_dir), up=f(up), fov=f(fov),
                   focus_plane=f(focus_plane), aperture=f(aperture),
                   shutter=f(shutter))


@dataclass(frozen=True)
class RenderSettings:
    """Static render parameters (src/Scene.h:60-64 plus wavefront sizing);
    field meanings as in raytracer_tpu.core.types.RenderSettings."""
    width: int = 256
    height: int = 256
    path_trace: bool = False
    max_bounces: int = 5
    spec_bounce_cap: int = 5                 # src/Blinn.cpp:248
    # adaptive supersampling (render_adaptive, src/Scene.cpp:250-293)
    min_subdivs: int = 1
    max_subdivs: int = 1
    noise_threshold: float = 0.01
    max_wavefront_steps: int = 8
    shadow_segments: int = 4
    light_noise_cutoff: float = 0.0
    use_schlick: bool = False
    # 'auto' | 'cluster2' | 'brute' | 'pallas' | 'bvh' | 'ring' (a rank's
    # shard of the cluster table, ops/ring_trace.py)
    intersector: str = 'auto'
    ray_tile: int = 8 * 128
    sort_rays: bool = True
    # secondary (non-primary) rays draw one sample of the dome light
    # (src/DomeLight.cpp:89)
    light_secondary_single: bool = True
    # recompute each bounce step in the backward pass instead of keeping
    # its intermediates (the JAX field's jax.checkpoint of the scan body;
    # here torch.utils.checkpoint, render/integrator.radiance): autograd
    # keeps only each step's ray state, about 125 bytes a ray, and the
    # backward pass runs every step's forward once more
    remat: bool = False


@dataclass
class Scene(TensorData):
    """The full scene. A single-level scene carries `clusters`; a
    two-level (instanced) one carries `instances` and `iclusters`, and
    `mb_clusters` when its world geometry is motion-blurred (`iclusters`
    is None when a prototype is motion-blurred: such scenes trace through
    the BVH). `edges` is the edge table of diff/edges.py, None beyond the
    instanced pair cap. `blas` is the merged BVH of a scene built with
    bvh=True (None otherwise) and `bvh_root` its entry node. `tlas` only
    keeps the JAX Scene's field list: nothing sets or reads it, in either
    package (the TLAS lives in `blas`'s pool), and convert.py ignores it."""
    geom: Geometry
    materials: Materials
    textures: TexturePack
    point_lights: PointLights
    rect_lights: RectLights
    env_exposure: torch.Tensor           # ()
    bg_color: torch.Tensor               # (3,)
    dome: Optional[DomeLight] = None
    clusters: Optional[object] = None    # geometry.clusters.Clusters
    instances: Optional[Instances] = None
    iclusters: Optional[object] = None   # geometry.clusters.InstancedClusters
    mb_clusters: Optional[object] = None  # geometry.clusters.Clusters
    edges: Optional[EdgeTable] = None
    blas: Optional[BVHArrays] = None
    tlas: Optional[BVHArrays] = None
    env_tex: int = -1
    # True when the scene is one identity instance of all its triangles
    single_level: bool = True
    has_motion_blur: bool = False
    has_alpha_maps: bool = False
    # some motion-blurred triangle has an alpha map
    mb_has_alpha: bool = False
    has_material_env: bool = False
    has_dispersion: bool = False
    has_translucency: bool = False
    # the traversal's entry node in the merged BVH pool: the TLAS root, or
    # the world BLAS root (node 0) of a single-level scene
    bvh_root: int = 0

    @property
    def num_tris(self) -> int:
        return self.geom.face_v.shape[0]
