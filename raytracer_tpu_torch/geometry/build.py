"""Host-side scene assembly: meshes, materials and lights -> Scene.

Port of raytracer_tpu/geometry/build.py, single-level or instanced, with
textures given as numpy images, motion blur, alpha maps, the env map and
the dome light: the same method names and defaults, the same array
layout, the same texel pool, dome tables, instance table and cluster
tables. Everything here is numpy until `build` wraps the arrays as
tensors and puts them on its `device` (the card unless the caller names
another). Both kinds of scene carry the edge table of diff/edges.py; an
instanced one also enumerates its (instance, edge) pairs, and beyond
diff/edges.PAIR_CAP of them carries none, as the JAX build does. With
bvh=True the scene also carries the merged wide BVH of geometry/bvh.py and
its instances' BLAS roots (the tables of the JAX build, byte for byte),
which intersector='bvh' traces; the default is bvh=False (the JAX
builder's is True), since the cluster tables carry every other tracer.
Image files load through io/imageio.load_image (`add_texture_file`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import types as T
from ..diff.edges import PAIR_CAP, build_edge_table
from ..io import imageio
from ..io.objload import MeshData, compute_tangents
from . import bvh as bvh_mod
from . import clusters as cl_mod


def _bilinear_lookup(img: np.ndarray, u: np.ndarray, v: np.ndarray
                     ) -> np.ndarray:
    """Numpy mirror of Texture::getLookup (src/Texture.cpp:43-72): wrap,
    flip v, bilinear with tiled pixel fetch. img is (H, W, C)
    top-row-first. Copied from raytracer_tpu/geometry/build.py."""
    h, w = img.shape[:2]
    u = u - np.trunc(u)
    v = v - np.trunc(v)
    u = np.where(u < 0, u + 1.0, u)
    v = np.where(v < 0, v + 1.0, v)
    v = 1.0 - v
    px = u * w
    py = v * h
    x1 = np.floor(px).astype(np.int64)
    y1 = np.floor(py).astype(np.int64)
    dx = (px - x1)[..., None]
    dy = (py - y1)[..., None]
    x2 = (x1 + 1) % w
    y2 = (y1 + 1) % h
    x1 %= w
    y1 %= h
    q1 = img[y1, x1] * (1 - dx) + img[y1, x2] * dx
    q2 = img[y2, x1] * (1 - dx) + img[y2, x2] * dx
    return q1 * (1 - dy) + q2 * dy


def _edge_pairs(edges: T.EdgeTable, instances: list[dict]):
    """The edge table with its flat (instance, edge) pairs: each instance
    row pairs with the edges whose first face lies in its triangles, in
    edge order; None beyond diff/edges.PAIR_CAP pairs. The JAX build's
    enumeration (raytracer_tpu/geometry/build.py:400-436): pairs are
    counted per prototype before any is made."""
    fid0 = edges.fid[:, 0].numpy()
    sel_cache: dict = {}

    def inst_sel(inst):
        k = ('t', id(inst['tris'])) if inst['tris'] is not None \
            else (inst['lo'], inst['hi'])
        if k not in sel_cache:
            if inst['tris'] is not None:
                sel_cache[k] = np.flatnonzero(
                    np.isin(fid0, np.asarray(inst['tris'])))
            else:
                sel_cache[k] = np.flatnonzero(
                    (fid0 >= inst['lo']) & (fid0 < inst['hi']))
        return sel_cache[k]

    if sum(len(inst_sel(inst)) for inst in instances) > PAIR_CAP:
        return None
    pi = [np.full(len(inst_sel(inst)), row, np.int32)
          for row, inst in enumerate(instances)]
    pe = [inst_sel(inst).astype(np.int32) for inst in instances]
    return T.EdgeTable(vid=edges.vid, fid=edges.fid,
                       pair_inst=torch.from_numpy(np.concatenate(pi)),
                       pair_edge=torch.from_numpy(np.concatenate(pe)))


def _cdf_1d(f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distribution1D::computeStep1dCDF (src/DomeLight.h:21-30) over the
    last axis -> (cdf (..., n + 1), func_int). Copied from
    raytracer_tpu/geometry/build.py."""
    n = f.shape[-1]
    cdf = np.zeros(f.shape[:-1] + (n + 1,), np.float64)
    cdf[..., 1:] = np.cumsum(f, axis=-1) / n
    func_int = cdf[..., -1].copy()
    safe = np.where(func_int > 0, func_int, 1.0)
    cdf /= safe[..., None]
    return cdf.astype(np.float32), func_int.astype(np.float32)


class SceneBuilder:
    def __init__(self):
        self._verts: list[np.ndarray] = []
        self._verts_t1: list[np.ndarray] = []
        self._norms: list[np.ndarray] = []
        self._uvs: list[np.ndarray] = [np.zeros((1, 2), np.float32)]
        self._tans: list[np.ndarray] = []
        self._bitans: list[np.ndarray] = []
        self._face_v: list[np.ndarray] = []
        self._face_n: list[np.ndarray] = []
        self._face_t: list[np.ndarray] = []
        self._face_mat: list[np.ndarray] = []
        self._face_has_uv: list[np.ndarray] = []
        self._face_mb: list[np.ndarray] = []
        self._nv = 0
        self._nn = 0
        self._nt = 1  # slot 0 is a zero uv
        self._ntri = 0
        self._mats: list[dict] = []
        self._tex_imgs: list[np.ndarray] = []
        self._point_lights: list[dict] = []
        self._rect_lights: list[dict] = []
        self._dome: dict | None = None
        self._env_tex = -1
        self._env_exposure = 1.0
        self._bg = np.zeros(3, np.float32)
        self._has_mb = False
        # instancing: prototype triangle ranges [lo, hi) and placements
        self._protos: list[tuple[int, int]] = []
        self._open_proto: int | None = None
        self._instances: list[dict] = []

    # ----------------------------------------------------------- textures
    def add_texture(self, img: np.ndarray) -> int:
        """img: (H, W, C) float32, top row first. Returns the texture id."""
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        self._tex_imgs.append(img)
        return len(self._tex_imgs) - 1

    def add_texture_file(self, path: str) -> int:
        """A TGA, PPM or HDR file (io/imageio.load_image) as a texture."""
        img, _ = imageio.load_image(path)
        return self.add_texture(img)

    # ---------------------------------------------------------- materials
    def _add_material(self, kind, kd, ka, ks, ior, spec_exp, spec_amt,
                      reflect_amt, refract_amt, spec_gloss, translucency,
                      emitted_power, le, disperse, sample_env, env_exposure,
                      tex_color, tex_alpha, tex_normal, tex_spec, tex_reflect,
                      tex_refract, tex_env) -> int:
        def v3(x):
            return np.broadcast_to(np.asarray(x, np.float32), (3,)).copy()
        ior = np.asarray(ior, np.float32)
        if ior.ndim == 0:
            ior = np.repeat(ior[None], 3)
        self._mats.append(dict(
            kind=kind, kd=v3(kd), ka=v3(ka), ks=v3(ks), ior=ior,
            spec_exp=spec_exp, spec_amt=spec_amt, reflect_amt=reflect_amt,
            refract_amt=refract_amt, spec_gloss=spec_gloss,
            translucency=translucency, emitted_power=emitted_power, le=v3(le),
            disperse=disperse, sample_env=sample_env,
            env_exposure=env_exposure, tex_color=tex_color,
            tex_alpha=tex_alpha, tex_normal=tex_normal, tex_spec=tex_spec,
            tex_reflect=tex_reflect, tex_refract=tex_refract,
            tex_env=tex_env))
        return len(self._mats) - 1

    def add_lambert(self, kd=(1, 1, 1), ka=(0, 0, 0), tex_color=-1) -> int:
        return self._add_material(T.MAT_LAMBERT, kd, ka, (0, 0, 0), 1.0, 1.0,
                                  0.0, 0.0, 0.0, 1.0, 0.0, 0.0, (0, 0, 0),
                                  False, True, 1.0, tex_color, -1, -1, -1,
                                  -1, -1, -1)

    def add_blinn(self, kd=(1, 1, 1), ka=(0, 0, 0), ks=(1, 1, 1), kt=(0, 0, 0),
                  ior=1.5, spec_exp=1.0, spec_amt=0.0, reflect_amt=0.0,
                  refract_amt=0.0, spec_gloss=1.0, translucency=0.0,
                  emitted_power=0.0, le=(0, 0, 0), disperse=False,
                  sample_env=True, env_exposure=1.0, tex_color=-1,
                  tex_alpha=-1, tex_normal=-1, tex_spec=-1, tex_reflect=-1,
                  tex_refract=-1, tex_env=-1) -> int:
        """Defaults mirror the Blinn ctor (src/Blinn.cpp:15-33); `kt` is
        accepted for the same signature and, as in the reference, unused."""
        return self._add_material(
            T.MAT_BLINN, kd, ka, ks, ior, spec_exp, spec_amt, reflect_amt,
            refract_amt, spec_gloss, translucency, emitted_power, le,
            disperse, sample_env, env_exposure, tex_color, tex_alpha,
            tex_normal, tex_spec, tex_reflect, tex_refract, tex_env)

    # ----------------------------------------------------------- geometry
    def add_mesh(self, mesh: MeshData, material: int | np.ndarray,
                 mesh_t1: MeshData | None = None) -> None:
        """Append a mesh to the open prototype (or the static world).
        mesh_t1 gives the t = 1 vertex pose for motion blur (reference
        MBObject, src/MBObject.h:11-27); its topology must be mesh's."""
        if mesh.tangents is None:
            compute_tangents(mesh)
        ntri = mesh.num_tris
        self._verts.append(mesh.vertices)
        self._verts_t1.append(mesh.vertices if mesh_t1 is None
                              else mesh_t1.vertices.astype(np.float32))
        self._norms.append(mesh.normals)
        self._tans.append(mesh.tangents)
        self._bitans.append(mesh.bitangents)
        self._face_v.append(mesh.face_v + self._nv)
        self._face_n.append(mesh.face_n + self._nn)
        if mesh.texcoords is not None:
            self._uvs.append(mesh.texcoords)
            self._face_t.append(mesh.face_t + self._nt)
            self._face_has_uv.append(np.ones(ntri, bool))
            self._nt += len(mesh.texcoords)
        else:
            self._face_t.append(np.zeros((ntri, 3), np.int32))
            self._face_has_uv.append(np.zeros(ntri, bool))
        mat = np.asarray(material, np.int32)
        self._face_mat.append(np.broadcast_to(mat, (ntri,)).copy())
        self._face_mb.append(np.full(ntri, mesh_t1 is not None, bool))
        self._has_mb = self._has_mb or mesh_t1 is not None
        self._nv += len(mesh.vertices)
        self._nn += len(mesh.normals)
        self._ntri += ntri

    # ---------------------------------------------------------- instancing
    def begin_prototype(self) -> None:
        assert self._open_proto is None, 'prototype already open'
        self._open_proto = self._ntri

    def end_prototype(self) -> int:
        """Close the prototype; returns its id (src/ProxyObject.cpp:149-167)."""
        assert self._open_proto is not None
        self._protos.append((self._open_proto, self._ntri))
        self._open_proto = None
        return len(self._protos) - 1

    def add_instance(self, proto: int, m: np.ndarray) -> None:
        """m: (3, 4) or (4, 4) object -> world transform."""
        m = np.asarray(m, np.float32)
        if m.shape == (4, 4):
            m = m[:3]
        self._instances.append(dict(proto=proto, m=m))

    def _instance_dicts(self) -> list[dict]:
        """The implicit world prototype (the triangles no prototype
        claims, identity transform) first, then one dict per placement."""
        claimed = np.zeros(self._ntri, bool)
        for lo, hi in self._protos:
            claimed[lo:hi] = True
        world_tris = np.where(~claimed)[0].astype(np.int32)
        out = []
        if len(world_tris) > 0:
            out.append(dict(m=np.eye(3, 4, dtype=np.float32), lo=-1, hi=-1,
                            tris=world_tris))
        for inst in self._instances:
            lo, hi = self._protos[inst['proto']]
            out.append(dict(m=inst['m'], lo=lo, hi=hi, tris=None))
        return out

    # -------------------------------------------------------------- lights
    def add_point_light(self, position, power, color=(1, 1, 1),
                        cast_shadows=True, fast_shadows=True) -> None:
        self._point_lights.append(dict(
            position=np.asarray(position, np.float32), power=float(power),
            color=np.asarray(color, np.float32), cast_shadows=cast_shadows,
            fast_shadows=fast_shadows))

    def add_rect_light(self, v1, v2, v3, power, color=(1, 1, 1),
                       num_samples=1, cast_shadows=True,
                       fast_shadows=True) -> None:
        self._rect_lights.append(dict(
            v1=np.asarray(v1, np.float32), v2=np.asarray(v2, np.float32),
            v3=np.asarray(v3, np.float32), power=float(power),
            color=np.asarray(color, np.float32), num_samples=int(num_samples),
            cast_shadows=cast_shadows, fast_shadows=fast_shadows))

    def set_dome_light(self, tex: int, gain=1.0, num_samples=1,
                       cast_shadows=True, fast_shadows=True) -> None:
        self._dome = dict(tex=tex, gain=float(gain),
                          num_samples=int(num_samples),
                          cast_shadows=cast_shadows, fast_shadows=fast_shadows)

    def set_env_map(self, tex: int, exposure: float = 1.0) -> None:
        self._env_tex = tex
        self._env_exposure = float(exposure)

    def set_bg_color(self, color) -> None:
        self._bg = np.asarray(color, np.float32)

    # --------------------------------------------------------------- build
    def _build_dome(self) -> T.DomeLight | None:
        """2-D CDF over the lat-long map (src/DomeLight.cpp:8-78): a
        v-distribution per column weighted by sin(pi (v + .5) / nv), and a
        marginal over u from the column integrals."""
        if self._dome is None:
            return None
        img = self._tex_imgs[self._dome['tex']]
        nv_, nu_ = img.shape[0], img.shape[1]
        uu, vv = np.meshgrid(np.arange(nu_) / nu_, np.arange(nv_) / nv_,
                             indexing='ij')                 # (nu, nv)
        lum = _bilinear_lookup(img, uu, vv)[..., :3].mean(-1)
        sin_w = np.sin(np.pi * (np.arange(nv_) + 0.5) / nv_)
        v_func = (lum * sin_w[None, :]).astype(np.float32)   # (nu, nv)
        v_cdf, v_int = _cdf_1d(v_func)
        u_func = v_int.astype(np.float32)                    # (nu,)
        u_cdf, u_int = _cdf_1d(u_func)
        t = torch.from_numpy
        return T.DomeLight(
            gain=torch.tensor(self._dome['gain'], dtype=torch.float32),
            u_cdf=t(u_cdf), u_func=t(u_func),
            u_func_int=t(np.asarray(u_int, np.float32)), v_cdf=t(v_cdf),
            v_func=t(v_func), v_func_int=t(v_int), tex=self._dome['tex'],
            cast_shadows=self._dome['cast_shadows'],
            fast_shadows=self._dome['fast_shadows'],
            num_samples=self._dome['num_samples'])

    def build(self, bvh: bool = False, leaf_size: int = 4,
              device=T.CUDA) -> T.Scene:
        """Assemble the scene with its cluster tables (the flat table of a
        single-level scene, or the instance table and the two-level tables
        of an instanced one) on `device`; raises on the default CUDA device
        when no card is present. bvh=True also builds the merged wide BVH
        (leaves of up to leaf_size triangles, which must be the tracers'
        4: any other raises) and the instances' BLAS roots, as the JAX
        builder's default does; this builder's default is False."""
        dev = T.device_of(device)
        assert self._open_proto is None, 'unclosed prototype'
        assert self._ntri > 0, 'empty scene'
        t = torch.from_numpy
        cat = lambda xs, dt: t(np.concatenate(xs).astype(dt))
        face_v = np.concatenate(self._face_v).astype(np.int32)
        geom = T.Geometry(
            vertices=cat(self._verts, np.float32),
            vertices_t1=cat(self._verts_t1, np.float32),
            normals=cat(self._norms, np.float32),
            texcoords=cat(self._uvs, np.float32),
            tangents=cat(self._tans, np.float32),
            bitangents=cat(self._bitans, np.float32),
            face_v=t(face_v),
            face_n=cat(self._face_n, np.int32),
            face_t=cat(self._face_t, np.int32),
            face_mat=cat(self._face_mat, np.int32),
            face_has_uv=cat(self._face_has_uv, bool),
            face_mb=cat(self._face_mb, bool))

        if not self._mats:
            self.add_lambert()
        mats = self._mats

        def col(key, dtype=np.float32):
            return t(np.asarray([m[key] for m in mats], dtype))

        materials = T.Materials(
            kind=col('kind', np.int32), kd=col('kd'), ka=col('ka'),
            ks=col('ks'), ior=col('ior'), spec_exp=col('spec_exp'),
            spec_amt=col('spec_amt'), reflect_amt=col('reflect_amt'),
            refract_amt=col('refract_amt'), spec_gloss=col('spec_gloss'),
            translucency=col('translucency'),
            emitted_power=col('emitted_power'), le=col('le'),
            disperse=col('disperse', bool), sample_env=col('sample_env', bool),
            env_exposure=col('env_exposure'),
            **{k: col(k, np.int32) for k in (
                'tex_color', 'tex_alpha', 'tex_normal', 'tex_spec',
                'tex_reflect', 'tex_refract', 'tex_env')})

        # all images in one texel pool; without textures an EMPTY pool, so
        # every texture lookup short-circuits statically
        imgs = self._tex_imgs
        flats = [img.reshape(-1) for img in imgs]
        i32 = lambda xs: t(np.asarray(xs, np.int32).reshape(-1))
        textures = T.TexturePack(
            data=t(np.concatenate(flats).astype(np.float32) if flats
                   else np.zeros(0, np.float32)),
            offset=i32(np.cumsum([0] + [len(x) for x in flats[:-1]])
                       if flats else []),
            width=i32([i.shape[1] for i in imgs]),
            height=i32([i.shape[0] for i in imgs]),
            channels=i32([i.shape[2] for i in imgs]))

        def rows(ls, key, width=None):
            a = np.asarray([l[key] for l in ls], np.float32)
            return t(a.reshape(-1, width) if width else a)

        pls = self._point_lights
        point_lights = T.PointLights(
            position=rows(pls, 'position', 3), power=rows(pls, 'power'),
            color=rows(pls, 'color', 3),
            cast_shadows=tuple(bool(l['cast_shadows']) for l in pls),
            fast_shadows=tuple(bool(l['fast_shadows']) for l in pls))
        rls = self._rect_lights
        rect_lights = T.RectLights(
            v1=rows(rls, 'v1', 3), v2=rows(rls, 'v2', 3),
            v3=rows(rls, 'v3', 3), power=rows(rls, 'power'),
            color=rows(rls, 'color', 3),
            cast_shadows=tuple(bool(l['cast_shadows']) for l in rls),
            fast_shadows=tuple(bool(l['fast_shadows']) for l in rls),
            num_samples=max([l['num_samples'] for l in rls], default=1))

        instances = self._instance_dicts()
        single_level = (len(instances) == 1
                        and instances[0]['tris'] is not None
                        and len(instances[0]['tris']) == self._ntri)
        edges = build_edge_table(face_v)
        if bvh:
            blas, inst_table, root = bvh_mod.build_scene_bvh(
                geom, instances, leaf_size=leaf_size)
            tables = dict(blas=blas, bvh_root=root, instances=inst_table)
        else:
            tables, inst_table = {}, None
        if single_level:
            tables.update(clusters=cl_mod.build_clusters(geom), edges=edges)
        else:
            if inst_table is None:
                inst_table = bvh_mod.instance_table(instances, self._ntri)
            icl, mb = cl_mod.build_instanced_clusters(geom, instances,
                                                      inst_table)
            tables.update(instances=inst_table, iclusters=icl,
                          mb_clusters=mb,
                          edges=_edge_pairs(edges, instances))

        alpha_of_face = materials.tex_alpha[geom.face_mat.long()] >= 0
        return T.Scene(
            geom=geom, materials=materials, textures=textures,
            point_lights=point_lights, rect_lights=rect_lights,
            dome=self._build_dome(),
            env_exposure=torch.tensor(self._env_exposure,
                                      dtype=torch.float32),
            bg_color=t(self._bg.copy()), env_tex=self._env_tex,
            single_level=single_level, **tables,
            has_motion_blur=self._has_mb,
            has_alpha_maps=bool(alpha_of_face.any()),
            mb_has_alpha=bool(alpha_of_face[geom.face_mb].any()),
            has_material_env=bool((materials.tex_env >= 0).any()),
            has_dispersion=bool(materials.disperse.any()),
            has_translucency=bool((materials.translucency > 0.01).any())
        ).to(dev)
