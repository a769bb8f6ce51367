"""The native host builders and OBJ parser, loaded with ctypes.

Compiles this package's own rt_native.cpp (a framework-free C ABI, the
same arithmetic as the JAX package's native library) with g++ into the
package's git-ignored build directory on first use, and binds
`rt_build_clusters` (the cluster table), `rt_build_bvh` (one wide BLAS of
geometry/bvh.py) and the two-pass OBJ parser `rt_obj_count` /
`rt_obj_fill`. Nothing outside this package is read. A failed build
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'rt_native.cpp')
BUILD_DIR = os.path.join(_PKG, '_build')
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
_lock = threading.Lock()
_lib = None


def library_path(src: str, flags: list[str], name: str,
                 deps: tuple[str, ...] = ()) -> str:
    """BUILD_DIR/<name>-<hash>.so: the hash covers the source, the files
    it includes (`deps`) and the flags, so an edit to any of them
    rebuilds."""
    digest = hashlib.sha1()
    for path in (src, *deps):
        with open(path, 'rb') as f:
            digest.update(f.read())
    digest.update(' '.join(flags).encode())
    return os.path.join(BUILD_DIR, f'{name}-{digest.hexdigest()[:12]}.so')


def build_shared(cmd_prefix: list[str], src: str, flags: list[str],
                 name: str, deps: tuple[str, ...] = ()) -> str:
    """Compile `src` into library_path(...) unless that file exists.

    The output is written under a temporary name and renamed into place, so
    processes that build at once never load a half-written library. What
    the compiler prints on success (nvcc -Xptxas -v: registers, spills and
    shared memory per kernel) is kept beside it as <name>-<hash>.log."""
    out = library_path(src, flags, name, deps)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(cmd_prefix + flags + [src, '-o', tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'building {src} failed:\n{res.stderr}')
        with open(out[:-3] + '.log', 'w') as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(['g++'], SRC, _FLAGS, 'rt_native'))
            fp = np.ctypeslib.ndpointer
            f32 = fp(np.float32, flags='C')
            lib.rt_build_clusters.restype = ctypes.c_int64
            lib.rt_build_clusters.argtypes = [
                f32, f32, fp(np.int32, flags='C'), fp(np.int64, flags='C'),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
                f32, f32, f32, f32, f32, f32, f32, f32,
                fp(np.int32, flags='C')]
            lib.rt_build_bvh.restype = ctypes.c_int64
            lib.rt_build_bvh.argtypes = [
                f32, f32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, f32, f32,
                fp(np.int32, flags='C'), fp(np.int32, flags='C'),
                fp(np.int64, flags='C'), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32)]
            lib.rt_obj_count.restype = ctypes.c_int
            lib.rt_obj_count.argtypes = [ctypes.c_char_p,
                                         fp(np.int64, flags='C')]
            lib.rt_obj_fill.restype = ctypes.c_int
            lib.rt_obj_fill.argtypes = [ctypes.c_char_p, f32, f32, f32,
                                        fp(np.int32, flags='C'),
                                        fp(np.int32, flags='C'),
                                        fp(np.int32, flags='C')]
            _lib = lib
    return _lib


def build_clusters_native(verts: np.ndarray, verts_t1: np.ndarray,
                          faces: np.ndarray, tri_ids: np.ndarray,
                          cluster_size: int, has_mb: bool):
    """Binned-SAH cluster build (leaf = cluster_size) over boxes that bound
    both motion poses.

    Returns (bb_min, bb_max, p0, e1, e2, q0, q1, q2, tri) with one row per
    cluster; the t = 1 basis q* is p0/e1/e2 itself unless has_mb."""
    lib = get_lib()
    n = len(tri_ids)
    C = cluster_size
    va = np.ascontiguousarray(verts, np.float32).reshape(-1)
    vb = np.ascontiguousarray(verts_t1, np.float32).reshape(-1)
    fa = np.ascontiguousarray(faces, np.int32).reshape(-1)
    ta = np.ascontiguousarray(tri_ids, np.int64)
    # SAH leaves average well above C/4 triangles; grow on overflow
    cap = max(8 * ((n + C - 1) // C) + 8, 8)
    while True:
        bb_min = np.empty((cap, 3), np.float32)
        bb_max = np.empty((cap, 3), np.float32)
        p0, e1, e2 = (np.empty((cap, 3, C), np.float32) for _ in range(3))
        # the t = 1 pose is never written when static: 1-row dummies
        qcap = cap if has_mb else 1
        q0, q1, q2 = (np.empty((qcap, 3, C), np.float32) for _ in range(3))
        tri = np.empty((cap, C), np.int32)
        m = lib.rt_build_clusters(
            va, vb, fa, ta, n, C, int(has_mb), cap, bb_min.reshape(-1),
            bb_max.reshape(-1), p0.reshape(-1), e1.reshape(-1),
            e2.reshape(-1), q0.reshape(-1), q1.reshape(-1), q2.reshape(-1),
            tri.reshape(-1))
        if m >= 0:
            break
        if cap >= n + 8:
            raise RuntimeError('rt_build_clusters overflowed its table')
        cap = min(cap * 4, n + 8)
    out = (bb_min[:m], bb_max[:m], p0[:m], e1[:m], e2[:m])
    if has_mb:
        return out + (q0[:m], q1[:m], q2[:m], tri[:m])
    return out + (p0[:m], e1[:m], e2[:m], tri[:m])


def build_bvh_native(bmin: np.ndarray, bmax: np.ndarray, leaf_size: int,
                     branch: int, prim_off: int, node_base: int):
    """Binned-SAH build of one BLAS over primitive boxes, collapsed to
    `branch`-wide nodes -> (node_min, node_max, child, count, order,
    depth): leaf starts offset by prim_off, internal child ids by
    node_base (geometry/bvh._WidePool.add_block)."""
    lib = get_lib()
    n = len(bmin)
    cap = 2 * n + 8
    node_min = np.empty((cap, branch, 3), np.float32)
    node_max = np.empty((cap, branch, 3), np.float32)
    child = np.empty((cap, branch), np.int32)
    count = np.empty((cap, branch), np.int32)
    order = np.empty(n, np.int64)
    depth = ctypes.c_int32(0)
    n_nodes = lib.rt_build_bvh(
        np.ascontiguousarray(bmin, np.float32),
        np.ascontiguousarray(bmax, np.float32), n, leaf_size, branch,
        prim_off, node_base, node_min.reshape(-1), node_max.reshape(-1),
        child.reshape(-1), count.reshape(-1), order, cap,
        ctypes.byref(depth))
    if n_nodes < 0:
        raise RuntimeError('rt_build_bvh overflowed its node table')
    return (node_min[:n_nodes], node_max[:n_nodes], child[:n_nodes],
            count[:n_nodes], order, int(depth.value))


def parse_obj_native(path: str):
    """The two-pass OBJ parse -> dict of raw arrays (v, vt, vn, fv, ft,
    fn, has_t, has_n), or None for a file without vertices or faces (the
    JAX package then parses it in Python). Raises if the file cannot be
    read."""
    lib = get_lib()
    counts = np.zeros(6, np.int64)
    if lib.rt_obj_count(path.encode(), counts) != 0:
        raise OSError(f'cannot read {path}')
    nv, nvt, nvn, ntri, has_t, has_n = (int(x) for x in counts)
    if nv == 0 or ntri == 0:
        return None
    v = np.empty((nv, 3), np.float32)
    vt = np.empty((max(nvt, 1), 2), np.float32)
    vn = np.empty((max(nvn, 1), 3), np.float32)
    fv, ft, fn = (np.empty((ntri, 3), np.int32) for _ in range(3))
    if lib.rt_obj_fill(path.encode(), v.reshape(-1), vt.reshape(-1),
                       vn.reshape(-1), fv.reshape(-1), ft.reshape(-1),
                       fn.reshape(-1)) != 0:
        raise OSError(f'cannot read {path}')
    return dict(v=v, vt=vt[:nvt], vn=vn[:nvn], fv=fv, ft=ft, fn=fn,
                has_t=bool(has_t), has_n=bool(has_n))
