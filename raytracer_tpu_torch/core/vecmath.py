"""Batched 3-vector math on tensors whose last axis is the vector axis.

Port of raytracer_tpu/core/vecmath.py (the reference's SSE vector layer,
src/Vector3.h, as elementwise tensor math). Dot products are written out
component by component, so the sum order is fixed on every device.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..ops.cuda import take_kernel

# Reference constants (src/Miro.h:35-68)
MIRO_TMAX = 1e12
EPSILON = 1e-3            # src/Miro.h:56
PI = 3.1415926535897932
INV_PI = 1.0 / PI
INV_4PI = 0.25 / PI
TWO_PI_SQ = 2.0 * PI * PI
GAMMA = 2.2               # src/Image.cpp:14
# When set, the backward of each take and permute runs in a profiler range
# named by its call site (scripts/torch_frame_profile.py --train sets it).
# Off by default: a range also shows on the device's timeline, as an
# annotation spanning its kernels, which a profile that sums every device
# event (the benchmark's) would count twice.
PROFILE_SITES = False


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.index_select(x, 0, idx.reshape(-1).long())
    return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def scatter_rows(g: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    """The gradient of _gather(x, idx) for x of `shape`, given the output's
    gradient g: g's rows added into zeros at the rows idx names. On the
    CPU the plain version, zeros.index_add_, which is autograd's backward of
    index_select (so CPU gradients are those of index_select to the bit);
    on the card the take-scatter kernel (ops/cuda/take_kernel), which sums
    each index column's runs of equal indices before it adds, or raises."""
    if g.device.type == 'cpu':
        return g.new_zeros(shape).index_add_(
            0, idx.reshape(-1).long(), g.reshape((-1,) + tuple(shape[1:])))
    K = idx.shape[-1] if idx.dim() >= 2 else 1
    idx = idx.reshape(-1, K).contiguous()
    C = math.prod(shape[1:])
    out = take_kernel.scatter(g.reshape(idx.shape[0], K, C).contiguous(),
                              idx, shape[0])
    return out.reshape(shape)


def _site(name: str):
    return torch.profiler.record_function(name) if PROFILE_SITES \
        else contextlib.nullcontext()


class _Take(torch.autograd.Function):
    """_gather with scatter_rows as its backward, in a profiler range named
    by the call site under PROFILE_SITES."""

    @staticmethod
    def forward(ctx, x, idx, site):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.site = tuple(x.shape), site
        return _gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        with _site(ctx.site):
            return scatter_rows(g, idx, ctx.shape), None, None


class _Permute(torch.autograd.Function):
    """x[perm] for a permutation perm, whose backward is the gather of the
    gradient by the inverse permutation `inv`."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return torch.index_select(x, 0, perm)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        with _site('sort'):
            return torch.index_select(g, 0, inv), None, None


def take(x: torch.Tensor, idx: torch.Tensor, site: str = 'take'
         ) -> torch.Tensor:
    """x[idx] along the first axis, as index_select, for an index of any
    shape (the result has idx's shape, then x's trailing axes).

    Its backward is scatter_rows: on the card the take-scatter kernel sees
    the index as (N, K), its last axis (K = 1 for a flat index) being the
    columns along which it finds runs of equal rows, such as a triangle's
    three corners. Advanced indexing's backward would sort the indices and
    sum each run of duplicates serially, which is slow when millions of
    rays read a few rows (a material table). `site` names the backward's
    profiler range under PROFILE_SITES (a plain label, as
    `corners` or `kd`). Tables that are not floating point, or
    need no gradient, take index_select and keep no graph."""
    if x.is_floating_point() and x.requires_grad and torch.is_grad_enabled():
        return _Take.apply(x, idx, site)
    return _gather(x, idx)


def permute(x: torch.Tensor, perm: torch.Tensor, inv) -> torch.Tensor:
    """x[perm] for a permutation perm of x's rows (int64, as argsort
    gives), whose backward gathers the gradient by `inv`, the inverse
    permutation: exact and without atomics on either device (its values
    are index_add's over the permutation, except that a -0.0 gradient
    stays -0.0 where index_add's zeros + -0.0 gives +0.0). `inv` may be
    None where x needs no gradient."""
    if x.requires_grad and torch.is_grad_enabled():
        if inv is None:
            raise ValueError('permute: x needs a gradient, which needs inv')
        return _Permute.apply(x, perm, inv)
    return torch.index_select(x, 0, perm)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, which is dropped."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length2(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 4) affine matrices to (..., 3) points, each row
    summed in the order m0*x + m1*y + m2*z + m3."""
    return transform_vector(m, p) + m[..., :3, 3]


def transform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply the linear part of (..., 3, 3) or (..., 3, 4) matrices to
    (..., 3) vectors."""
    x, y, z = v[..., None, 0], v[..., None, 1], v[..., None, 2]
    return m[..., :3, 0] * x + m[..., :3, 1] * y + m[..., :3, 2] * z


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: a * rsqrt(max(|a|^2, eps))."""
    return a * torch.rsqrt(torch.clamp(length2(a), min=eps))[..., None]


def sqrt_pos(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) whose gradient is 0, not inf, where x <= 0.

    The JAX package writes sqrt(maximum(0, x)); at x == 0 exactly (normal
    incidence in the Fresnel terms, a grazing refraction) the sqrt's
    derivative is inf, and the zero cotangent of a branch that a `where`
    drops then makes it 0 * inf = NaN, which reaches the vertex
    gradients. Same forward values."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def refract(d, n, v_dot_n, eta):
    """Refraction direction (src/Blinn.cpp:305-307); under total internal
    reflection the sqrt clamps to 0, as the reference's max(0, .)."""
    sqrt_part = sqrt_pos(1.0 - (eta * eta) * (1.0 - v_dot_n * v_dot_n))
    t = eta[..., None] * d + n * (eta * v_dot_n - sqrt_part)[..., None]
    return normalize(t)


def fresnel(n1, n2, cos_theta_i):
    """Full Fresnel reflectance, s-polarisation form (src/Material.h:47-54)."""
    cos_theta_i = torch.clamp(cos_theta_i, 0.0, 1.0)
    sin_theta_i = sqrt_pos(1.0 - cos_theta_i * cos_theta_i)
    n1_cos = n1 * cos_theta_i
    s = n1 * sin_theta_i / n2
    n2_cos = n2 * sqrt_pos(1.0 - s * s)
    rs = (n1_cos - n2_cos) / torch.clamp(n1_cos + n2_cos, min=1e-12)
    return rs * rs


def schlick_fresnel(n1, n2, cos_theta_i):
    """Schlick approximation with TIR handling (src/Material.h:55-67)."""
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    n = n1 / n2
    sin_t2 = n * n * (1.0 - cos_theta_i * cos_theta_i)
    tir = (n1 > n2) & (sin_t2 > 1.0)
    cos_x = torch.where(n1 > n2, sqrt_pos(1.0 - sin_t2), cos_theta_i)
    x = 1.0 - cos_x
    out = r0 + (1.0 - r0) * x * x * x * x * x
    return torch.where(tir, torch.ones_like(out), out)


def build_onb(n: torch.Tensor):
    """Orthonormal basis (u, v) around n (src/Material.cpp:26-27)."""
    pick_y = n[..., 0:1].abs() > 0.1
    ey = n.new_tensor([0.0, 1.0, 0.0])
    ex = n.new_tensor([1.0, 0.0, 0.0])
    a = torch.where(pick_y, ey, ex)
    u = normalize(cross(a.expand_as(n), n))
    v = cross(n, u)
    return u, v


def cosine_sample(n, e1, e2):
    """Cosine-distributed hemisphere sample around n, with the reference's
    e2 <= 0.99 clamp (src/Material.cpp:14-42)."""
    e2 = torch.clamp(e2, max=0.99)
    u, v = build_onb(n)
    phi = 2.0 * PI * e1
    se2 = torch.sqrt(e2)
    s1e2 = torch.sqrt(1.0 - e2)
    out = (torch.cos(phi) * se2)[..., None] * u \
        + (torch.sin(phi) * se2)[..., None] * v + s1e2[..., None] * n
    return normalize(out)


def linear_to_gamma_f(c: torch.Tensor) -> torch.Tensor:
    """Image::linear_to_gammaF with its 15-bit input quantisation."""
    idx = torch.floor(torch.clamp(c, 0.0, 1.0) * 32767.0)
    return torch.pow(idx / 32768.0, 1.0 / GAMMA) * 255.0 + 0.5


def tone_map_u8(c: torch.Tensor) -> torch.Tensor:
    """Linear radiance -> 8-bit gamma pixels (Image::Map, src/Image.cpp:71-76)."""
    linear = torch.floor(torch.clamp(torch.clamp(c, min=0.0) * 32768.0,
                                     max=32768.0))
    g = torch.pow(linear / 32768.0, 1.0 / GAMMA) * 255.0 + 0.5
    return torch.floor(g).to(torch.uint8)
