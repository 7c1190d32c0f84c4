"""Fused per-bounce kernels: hit record, and shading + carry update, with
their VJPs (counterpart of ``sexy_raytracer_tpu/ops/fused.py:50-565``).

* ``hitrec_fused`` replaces ``_hitrec_kernel`` (fused.py:442, math
  ``hitrec_math`` :141) forward and ``_hitrec_bwd_kernel`` (fused.py:446)
  backward: the hit record from the winning triangle and sphere rows.
* ``shade_carry_fused`` replaces ``_shade_kernel`` (fused.py:501, math
  ``shade_carry_math`` :271) forward and ``_shade_bwd_kernel``
  (fused.py:505) backward: all four materials, emission, and the path
  carry update.

Both are ``torch.autograd.Function``s, the counterpart of the JAX
``custom_vjp``s. Every per-ray input is one row of a ``[K, R]`` float32
stack, rays contiguous — the TPU's ``[K, RB, 128]`` planes flattened. The
row maps below are the JAX package's, so stacks compare one to one. On
CUDA tensors the wrappers launch the kernels of ``csrc/fused.cu``; on CPU
tensors they run the plain versions here, which are the kernels'
specification: the math, and ``torch.autograd.grad`` of the math for the
backward (the in-kernel ``jax.vjp`` of the TPU). Rows that JAX stops the
gradient of are detached in the math, so their cotangents come back zero.
``torch.maximum``/``minimum`` stand where JAX has ``jnp.maximum``/``clip``:
they split the gradient of a tie half and half as JAX does
(``torch.clamp`` gives it all to the input).

Kernel note (all four). Each reads its ray's column of the input stacks
and writes its column of the output, coalesced across a warp. On paper
all four are bound by device memory: (34 + 16) x 4 B a ray for the hit
record, (75 + 6 + 16) x 4 B for the shade kernel, (34 + 16 + 34) x 4 B
and (75 + 6 + 16 + 75) x 4 B for their VJPs, against a few hundred
float32 operations (a few thousand for the shade VJP). The forwards keep
everything between the stacks in registers, as the TPU kernels keep it in
VMEM; a backward kernel re-runs the forward of its ray and walks a
hand-written adjoint in reverse, as the TPU's in-kernel ``jax.vjp`` saves
no intermediates either. On an H100 80GB HBM3 at 700 W (``PERF.md``) the
hit record and its VJP run one thread a ray near their copy floors, the
shade kernel is staged at its copy floor, and the shade VJP is bound by
its chain of dependent operations: see ``_hitrec``, ``_shade`` and
``shade_bwd``.
"""

from __future__ import annotations

import torch

from sexy_raytracer_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_LIGHT,
    MAT_METAL,
    MAT_PBR,
)
from sexy_raytracer_tpu_torch.ops import _cuda
from sexy_raytracer_tpu_torch.utils.mathx import (
    EPSILON,
    PI,
    clip as _clip,
    maximum as _max,
    minimum as _min,
    safe_sqrt as _safe_sqrt,
)

# HF rows (f32 input stack, NHF total):
#   0-2 org | 3-5 dir | 6 time | 7-21 tri row g[0:15]
#   (v0 v1 v2 uv0 uv1 uv2) | 22-30 sph row s[0:9] (c0 c1 t0 t1 radius)
#   | 31 t_min | 32 is_tri (0/1) | 33 is_sph (0/1)
NHF = 34
# HO rows (f32 output stack):
#   0-2 p | 3-5 normal | 6-8 tangent | 9-11 bitangent | 12-13 TRIANGLE uv
#   (sphere-lane uv is set by the integrator) | 14 t | 15 front (0/1)
NHO = 16
# SF rows (f32 input stack):
#   0-2 org | 3-5 dir | 6-8 thr | 9-11 rad | 12 alive | 13-15 p
#   | 16-18 normal | 19-21 tangent | 22-24 bitangent | 25 front | 26 hit
#   | 27-56 gf[0:30] | 57-64 pack[0:8] | 65-67 rand unit_vector
#   | 68-70 rand unit_ball | 71 rand uniform | 72-74 background
NSF = 75
SF_GF = 27
SF_PACK = 57
SF_IOR = SF_GF + 7  # gf[7] = ior. Invariant: miss/pad lanes gather material
#   row 0, whose ior is 1.0 because every non-dielectric constructor in
#   models/scene.py stores ior=1.0 — keep that builder default or dielectric
#   refraction ratios on dead lanes go 0/NaN.
# SI rows (i32 input stack): mtype, albedo_kind, normal_kind, metal_kind,
#   rough_kind, emit_kind
NSI = 6
# SO rows: 0-2 org' | 3-5 dir' | 6-8 thr' | 9-11 rad' | 12 alive' | 13-15 pad
NSO = 16

HITREC = _cuda.Kernel(
    "srt_hitrec", "pip",
    source="sexy_raytracer_tpu_torch/csrc/fused.cu",
    replaces="sexy_raytracer_tpu/ops/fused.py:442 (_hitrec_kernel)",
)
SHADE = _cuda.Kernel(
    "srt_shade", "ppip",
    source="sexy_raytracer_tpu_torch/csrc/fused.cu",
    replaces="sexy_raytracer_tpu/ops/fused.py:501 (_shade_kernel)",
)
HITREC_BWD = _cuda.Kernel(
    "srt_hitrec_bwd", "ppip",
    source="sexy_raytracer_tpu_torch/csrc/fused.cu",
    replaces="sexy_raytracer_tpu/ops/fused.py:446 (_hitrec_bwd_kernel)",
)
SHADE_BWD = _cuda.Kernel(
    "srt_shade_bwd", "pppip",
    source="sexy_raytracer_tpu_torch/csrc/fused.cu",
    replaces="sexy_raytracer_tpu/ops/fused.py:505 (_shade_bwd_kernel)",
)
# Rays a tile and stages of the shade kernel's ring (SHADE_TR and
# SHADE_STAGES in csrc/fused.cu), rays a tile of its VJP, one warp a block
# (SHADE_BWD_TR), and threads a block of the kernels that run one thread a
# ray (THREADS)
SHADE_TILE_RAYS, SHADE_STAGES = 64, 3
SHADE_BWD_TILE_RAYS = 32
BLOCK_THREADS = 256
# The copy floor of the shade-family kernels: measurement only, replaces
# nothing and no path launches it (``stack_copy``), built for the stack
# shapes (f32 rows in, int rows in, rows out) of kernels 3, 4, 5 and 6,
# each kernel's f32 inputs stacked into one
STACK_COPY = _cuda.Kernel(
    "srt_stack_copy", "pipiipi",
    source="sexy_raytracer_tpu_torch/csrc/fused.cu",
    replaces="",
)
COPY_SHAPES = ((NHF, 0, NHO), (NSF, NSI, NSO), (NHF + NHO, 0, NHF),
               (NSF + NSO, NSI, NSF))


# ---------------------------------------------------------------------------
# vector helpers on component triples of [R] rows (fused.py:62-123)
# ---------------------------------------------------------------------------

def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _vscale(s, v):
    return (s * v[0], s * v[1], s * v[2])


def _vmul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _vneg(v):
    return (-v[0], -v[1], -v[2])


def _vcross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _where(m, a, b):
    return torch.where(m, a, b)


def _vwhere(m, a, b):
    return (_where(m, a[0], b[0]), _where(m, a[1], b[1]),
            _where(m, a[2], b[2]))




def _vunit(v):
    len2 = _vdot(v, v)
    inv = 1.0 / _safe_sqrt(len2)
    return _vwhere(len2 == 0.0, v, _vscale(inv, v))


def _vreflect(v, n):
    return _vsub(v, _vscale(2.0 * _vdot(v, n), n))


def _vrefract(uv, n, ratio):
    cos_theta = _min(_vdot(n, _vneg(uv)), 1.0)
    perp = _vscale(ratio, _vadd(uv, _vscale(cos_theta, n)))
    par = _vscale(-_safe_sqrt(torch.abs(1.0 - _vdot(perp, perp))), n)
    return _vadd(perp, par)


# ---------------------------------------------------------------------------
# hit record
# ---------------------------------------------------------------------------

def hitrec_math(F):
    """[NHF, *B] f32 -> [NHO, *B] f32 (plain version of the hitrec kernel).
    ``F`` may also be the sequence of its rows."""
    org = (F[0], F[1], F[2])
    dr = (F[3], F[4], F[5])
    time = F[6]
    v0 = (F[7], F[8], F[9])
    v1 = (F[10], F[11], F[12])
    v2 = (F[13], F[14], F[15])
    uv0 = (F[16], F[17])
    uv1 = (F[18], F[19])
    uv2 = (F[20], F[21])
    c0 = (F[22], F[23], F[24])
    c1 = (F[25], F[26], F[27])
    st0, st1, srad = F[28], F[29], F[30]
    t_min = F[31]
    is_tri = F[32] > 0.5

    # --- triangle (model.h:104-283 semantics via intersect.py) ---
    n = _vcross(_vsub(v1, v0), _vsub(v2, v0))
    ndir = _vdot(n, dr)
    d = -_vdot(n, v0)
    safe = _where(ndir == 0.0, -1.0, ndir)
    t_t = -(_vdot(n, org) + d) / safe
    p_t = _vadd(org, _vscale(t_t, dr))

    def invdist(v):
        w = _vsub(p_t, v)
        return 1.0 / _max(_safe_sqrt(_vdot(w, w)), 1e-20)

    r0, r1, r2 = invdist(v0), invdist(v1), invdist(v2)
    denom = r0 + r1 + r2
    r0, r1, r2 = r0 / denom, r1 / denom, r2 / denom
    # stop-gradient, as JAX (fused.py:173-174)
    u_t = (r0 * uv0[0] + r1 * uv1[0] + r2 * uv2[0]).detach()
    v_t = (1.0 - (r0 * uv0[1] + r1 * uv1[1] + r2 * uv2[1])).detach()

    outward_t = _vunit(n)
    front_t = _vdot(dr, outward_t) < 0.0
    normal_t = _vwhere(front_t, outward_t, _vneg(outward_t))

    e0 = _vsub(v1, v0)
    e1 = _vsub(v2, v0)
    duv0 = (uv1[0] - uv0[0], uv1[1] - uv0[1])
    duv1 = (uv2[0] - uv0[0], uv2[1] - uv0[1])
    f = duv0[0] * duv1[1] - duv1[0] * duv0[1]
    inv_f = 1.0 / _where(f == 0.0, EPSILON, f)
    tangent_t = _vunit(
        _vscale(inv_f, _vsub(_vscale(duv1[1], e0), _vscale(duv0[1], e1)))
    )
    bitangent_t = _vunit(
        _vscale(inv_f, _vadd(_vscale(-duv1[0], e0), _vscale(duv0[0], e1)))
    )

    # --- sphere (sphere.h:54-106 semantics via intersect.py) ---
    moving = (c0[0] != c1[0]) | (c0[1] != c1[1]) | (c0[2] != c1[2])
    sdenom = _where(st1 == st0, 1.0, st1 - st0)
    frac = (time - st0) / sdenom
    center = _vwhere(moving, _vadd(c0, _vscale(frac, _vsub(c1, c0))), c0)
    oc = _vsub(org, center)
    a = _vdot(dr, dr)
    half_b = _vdot(oc, dr)
    cterm = _vdot(oc, oc) - srad * srad
    disc = half_b * half_b - a * cterm
    sqrtd = _safe_sqrt(disc)
    safe_a = _where(a == 0.0, 1.0, a)
    root0 = (-half_b - sqrtd) / safe_a
    root1 = (-half_b + sqrtd) / safe_a
    t_s = _where(root0 >= t_min, root0, root1)
    p_s = _vadd(org, _vscale(t_s, dr))
    outward_s = _vunit(_vsub(p_s, center))  # no /radius (sphere.h:76)
    front_s = _vdot(dr, outward_s) < 0.0
    normal_s = _vwhere(front_s, outward_s, _vneg(outward_s))

    near_pole = (1.0 - torch.abs(outward_s[1])) < EPSILON
    zero = torch.zeros_like(outward_s[0])
    one = torch.ones_like(outward_s[0])
    b = _vwhere(near_pole, (zero, zero, -one), (zero, one, zero))
    tangent_s = _vunit(_vcross(b, outward_s))
    bitangent_s = _vunit(_vcross(outward_s, tangent_s))

    # --- select (intersect.hit_data pick) ---
    p = _vwhere(is_tri, p_t, p_s)
    normal = _vwhere(is_tri, normal_t, normal_s)
    tangent = _vwhere(is_tri, tangent_t, tangent_s)
    bitangent = _vwhere(is_tri, bitangent_t, bitangent_s)
    t = _where(is_tri, t_t, t_s)
    front = _where(is_tri, front_t, front_s)
    return torch.stack([
        p[0], p[1], p[2],
        normal[0], normal[1], normal[2],
        tangent[0], tangent[1], tangent[2],
        bitangent[0], bitangent[1], bitangent[2],
        u_t, v_t, t, front.to(torch.float32),
    ])


def hitrec_fused(hf):
    """[NHF, R] f32 -> [NHO, R] f32 hit-record stack, differentiable in
    ``hf`` through ``hitrec_bwd``. Where no gradient is asked for (the
    frame), the forward runs without the autograd Function's host path."""
    if torch.is_grad_enabled() and hf.requires_grad:
        return _HitrecFused.apply(hf)
    return _hitrec(hf)


def _hitrec(hf):
    """The forward: the kernel on CUDA tensors, the math on CPU tensors.

    Kernel note. Replaces ``_hitrec_kernel`` (fused.py:442). Bound: device
    memory, 34 x 4 B in and 16 x 4 B out per ray against about two hundred
    float32 operations. Like the TPU kernel's plane-wide select, the first
    port computed both the triangle and the sphere branch on every lane;
    the kernel (csrc/fused.cu ``hitrec_kernel``) computes only the branch
    each lane keeps (the triangle's uv, rows 12-13, on every lane), with
    the same operations, so its bits are the select's. One thread a ray
    runs it at its copy floor on an H100 80GB HBM3 at 700 W: kernel 4's
    staged ring, tried beside it, was no faster at the frame chunk
    (``PERF.md``).
    """
    if not hf.is_cuda:
        return hitrec_math(hf)
    _check_stack("hf", hf, NHF, torch.float32)
    out = torch.empty((NHO, hf.shape[1]), dtype=torch.float32,
                      device=hf.device)
    HITREC.launch(hf.device, _cuda.ptr(hf), hf.shape[1], _cuda.ptr(out))
    return out


class _HitrecFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hf):
        ctx.save_for_backward(hf)
        return _hitrec(hf)

    @staticmethod
    def backward(ctx, g):
        (hf,) = ctx.saved_tensors
        return hitrec_bwd(hf, g.contiguous())


def hitrec_bwd(hf, g):
    """VJP of the hit record: [NHF, R] stack, [NHO, R] cotangent ->
    [NHF, R] cotangent of the stack. The kernel on CUDA tensors,
    ``hitrec_vjp_plain`` on CPU tensors."""
    if not hf.is_cuda:
        return hitrec_vjp_plain(hf, g)
    _check_stack("hf", hf, NHF, torch.float32)
    _check_stack("g", g, NHO, torch.float32, like=hf)
    out = torch.empty_like(hf)
    HITREC_BWD.launch(hf.device, _cuda.ptr(hf), _cuda.ptr(g), hf.shape[1],
                      _cuda.ptr(out))
    return out


def hitrec_vjp_plain(hf, g):
    """Plain version of ``hitrec_bwd``: ``torch.autograd.grad`` of
    ``hitrec_math`` with cotangent ``g``, the rows read once (``_vjp``)."""
    return _vjp(hitrec_math, hf, g)


def _vjp(math, f, g, *args):
    """``torch.autograd.grad`` of ``math(rows, *args)`` at the rows of the
    [N, R] stack ``f``, with cotangent ``g``.

    The rows are taken once, by ``unbind``: one node then stacks their
    cotangents. Read as ``f[k]``, each row is a select whose backward
    zero-fills a whole [N, R] cotangent, N of them a call. The math, and
    so the order of every sum, is the same either way: the values are the
    select form's, but for zeros that keep their sign of -0.0 where the
    sum of the selects' zero-filled stacks gave +0.0
    (``tests/test_torch_fused.py``)."""
    with torch.enable_grad():
        F = f.detach().requires_grad_(True)
        (dF,) = torch.autograd.grad(math(F.unbind(0), *args), F, g)
    return dF


# ---------------------------------------------------------------------------
# shade + carry update
# ---------------------------------------------------------------------------

def shade_carry_math(F, I):
    """[NSF, *B] f32, [NSI, *B] i32 -> [NSO, *B] f32 (plain version of the
    shade kernel). ``F`` may also be the sequence of its rows."""
    org = (F[0], F[1], F[2])
    dr = (F[3], F[4], F[5])
    thr = (F[6], F[7], F[8])
    rad = (F[9], F[10], F[11])
    alive = F[12] > 0.5
    p = (F[13], F[14], F[15])
    nrm = (F[16], F[17], F[18])
    tan = (F[19], F[20], F[21])
    bit = (F[22], F[23], F[24])
    front = F[25] > 0.5
    hit = F[26] > 0.5

    def g(k):
        return F[SF_GF + k]

    def pk(k):
        return F[SF_PACK + k]

    # the random draws are stop-gradient, as JAX (fused.py:286-288)
    ruv = (F[65].detach(), F[66].detach(), F[67].detach())
    rball = (F[68].detach(), F[69].detach(), F[70].detach())
    runi = F[71].detach()
    bg = (F[72], F[73], F[74])
    mtype, ak, nk, mk, rk, ek = I[0], I[1], I[2], I[3], I[4], I[5]

    base_rgb = (g(0), g(1), g(2))
    albedo_c0 = (g(8), g(9), g(10))
    albedo_c1 = (g(11), g(12), g(13))
    emit_rgb = (g(14), g(15), g(16))
    emit_c1 = (g(17), g(18), g(19))
    normal_c0 = (g(24), g(25), g(26))
    normal_c1 = (g(27), g(28), g(29))
    zero3 = (torch.zeros_like(F[0]),) * 3
    one3 = (torch.ones_like(F[0]),) * 3

    # checker parity shared by every procedural slot (texture.h:42-48)
    odd = (torch.sin(10.0 * p[0]) * torch.sin(10.0 * p[1])
           * torch.sin(10.0 * p[2])) < 0.0

    # ---- PBR (material.h:156-245) ----
    checker = _vscale(255.0, _vwhere(odd, albedo_c1, albedo_c0))
    map_val = _vwhere(ak == 1, albedo_c0, (pk(0), pk(1), pk(2)))
    map_val = _vwhere(ak == 2, checker, map_val)
    attenuation = _vwhere(ak == 0, base_rgb, _vscale(1.0 / 255.0, map_val))

    nm_val = _vwhere(
        nk == 2, _vwhere(odd, normal_c1, normal_c0), (pk(3), pk(4), pk(5))
    )
    nm = _vscale(1.0 / 128.0, _vsub(nm_val, (128.0, 128.0, 128.0)))
    world_nm = _vadd(
        _vadd(_vscale(nm[0], tan), _vscale(nm[1], bit)), _vscale(nm[2], nrm)
    )
    normal = _vwhere(nk != 0, _vunit(world_nm), nrm)

    metallic, roughness = g(4), g(5)
    m_ck = _where(odd, g(21), g(20))
    m = _where(mk == 3, pk(6) / 255.0, metallic)
    m = _clip(_where(mk == 2, m_ck, m), 0.0, 1.0)
    m = _where(mk == 0, metallic, m)
    r_ck = _where(odd, g(23), g(22))
    r = _where(rk == 3, pk(7) / 255.0, roughness)
    r = _clip(_where(rk == 2, r_ck, r), 0.0, 1.0)
    r = _where(rk == 0, roughness, r)

    scatter = _vadd(normal, ruv)
    degen = ((torch.abs(scatter[0]) < 1e-8) & (torch.abs(scatter[1]) < 1e-8)
             & (torch.abs(scatter[2]) < 1e-8))
    scatter = _vunit(_vwhere(degen, normal, scatter))

    view = _vneg(_vunit(dr))
    half = _vunit(_vadd(scatter, view))
    n_dot_l = _max(_vdot(normal, scatter), 0.0)
    n_dot_h = _max(_vdot(normal, half), 0.0)
    h_dot_v = _max(_vdot(half, view), 0.0)
    n_dot_v = _max(_vdot(normal, view), 0.0)

    f0 = _vadd(_vscale(1.0 - m, (0.4, 0.4, 0.4)), _vscale(m, base_rgb))
    # guard 1e-12: the NaN guard of the GGX denominator (fused.py:346-351)
    alpha2 = (r * r) * (r * r)
    q = n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0
    dterm = alpha2 / _max(PI * (q * q), 1e-12)
    power = torch.exp2((-5.55473 * h_dot_v - 6.98316) * h_dot_v)
    fres = _vadd(f0, _vscale(power, _vsub(one3, f0)))
    rp1 = r + 1.0
    k = (rp1 * rp1) / 8.0
    gaf_l = n_dot_l / (n_dot_l * (1.0 - k) + k)
    gaf_v = n_dot_v / (n_dot_v * (1.0 - k) + k)
    gterm = gaf_l * gaf_v

    diffuse = _vmul(
        _vmul(_vscale(1.0 / PI, attenuation), _vsub(one3, fres)),
        _vscale(1.0 - m, base_rgb),
    )
    spec = _vscale(dterm * gterm / (4.0 * n_dot_v * n_dot_l + EPSILON), fres)
    pbr_att = _vscale(n_dot_l, _vadd(diffuse, spec))
    pbr_dir = scatter

    # ---- metal (material.h:87-102) ----
    fuzz = g(6)
    reflected = _vreflect(_vunit(dr), nrm)
    met_dir = _vadd(reflected, _vscale(fuzz, rball))
    met_ok = _vdot(met_dir, nrm) > 0.0
    met_att = base_rgb

    # ---- dielectric (material.h:104-137) ----
    ior = g(7)
    ratio = _where(front, 1.0 / ior, ior)
    ud = _vunit(dr)
    cos_t = _min(_vdot(nrm, _vneg(ud)), 1.0)
    sin_t = torch.sqrt(_max(1.0 - cos_t * cos_t, 0.0))
    cannot = ratio * sin_t > 1.0
    r0q = (1.0 - ratio) / (1.0 + ratio)
    r0c = r0q * r0q
    x = 1.0 - cos_t
    x5 = x * ((x * x) * (x * x))  # lax.integer_pow(x, 5)
    reflectance = r0c + (1.0 - r0c) * x5
    do_reflect = cannot | (reflectance > runi)
    die_dir = _vwhere(
        do_reflect, _vreflect(ud, nrm), _vrefract(ud, nrm, ratio)
    )

    # ---- diffuseLight emitted (material.h:139-154) ----
    emit_val = _vwhere(
        ek == 2,
        _vwhere(odd, emit_c1, emit_rgb),
        _vwhere(ek == 3, (pk(0), pk(1), pk(2)), emit_rgb),
    )
    emitted = _vwhere(mtype == MAT_LIGHT, emit_val, zero3)

    # ---- select by material id ----
    att = _vwhere(mtype == MAT_PBR, pbr_att, zero3)
    att = _vwhere(mtype == MAT_METAL, met_att, att)
    att = _vwhere(mtype == MAT_DIELECTRIC, one3, att)
    sdir = _vwhere(mtype == MAT_PBR, pbr_dir, dr)
    sdir = _vwhere(mtype == MAT_METAL, met_dir, sdir)
    sdir = _vwhere(mtype == MAT_DIELECTRIC, die_dir, sdir)
    scattered = (
        (mtype == MAT_PBR)
        | ((mtype == MAT_METAL) & met_ok)
        | (mtype == MAT_DIELECTRIC)
    ) & hit

    # ---- carry update (integrator bounce tail) ----
    miss = alive & ~hit
    takes = alive & hit
    rad = _vadd(rad, _vwhere(miss, _vmul(thr, bg), zero3))
    rad = _vadd(rad, _vwhere(takes, _vmul(thr, emitted), zero3))
    alive_next = alive & hit & scattered
    thr = _vwhere(alive_next, _vmul(thr, att), thr)
    org = _vwhere(alive_next, p, org)
    dr = _vwhere(alive_next, sdir, dr)

    z = zero3[0]
    return torch.stack([
        org[0], org[1], org[2],
        dr[0], dr[1], dr[2],
        thr[0], thr[1], thr[2],
        rad[0], rad[1], rad[2],
        alive_next.to(torch.float32), z, z, z,
    ])


def shade_carry_fused(sf, si):
    """([NSF, R] f32, [NSI, R] i32) -> [NSO, R] f32 next carry,
    differentiable in ``sf`` through ``shade_bwd``. Where no gradient is
    asked for (the frame), the forward runs without the autograd
    Function's host path."""
    if torch.is_grad_enabled() and sf.requires_grad:
        return _ShadeFused.apply(sf, si)
    return _shade(sf, si)


def _shade(sf, si):
    """The forward: the kernel on CUDA tensors, the math on CPU tensors.

    Kernel note. Replaces ``_shade_kernel`` (fused.py:501). Bound: device
    memory, (75 + 6) x 4 B in and 64 B out per ray against a few hundred
    float32 operations. The first port ran one thread a ray, each reading
    its column where ``shade_fwd`` first needed it: at 94 registers a
    quarter of the card's warps were resident, and every load waited in
    that ray's chain of sin, exp2 and divides (on an H100 80GB HBM3 at
    700 W, 0.081 ms on the device for the frame chunk, where a kernel that
    only streams the same stacks takes 0.068). The kernel is staged
    (csrc/fused.cu ``shade_staged_kernel``):
    persistent blocks, a producer lane that bulk-copies each tile's 81 row
    segments into a ring of shared-memory stages, the shading reading
    shared memory while the next tile lands, so that the loads no longer
    wait in the math's chain. Tiles are 64 rays and the ring three stages,
    the fastest of the shapes measured (all within 5%, ``PERF.md``).
    """
    if not sf.is_cuda:
        return shade_carry_math(sf, si)
    _check_stack("sf", sf, NSF, torch.float32)
    _check_stack("si", si, NSI, torch.int32, like=sf)
    out = torch.empty((NSO, sf.shape[1]), dtype=torch.float32,
                      device=sf.device)
    SHADE.launch(sf.device, _cuda.ptr(sf), _cuda.ptr(si), sf.shape[1],
                 _cuda.ptr(out))
    return out


class _ShadeFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sf, si):
        ctx.save_for_backward(sf, si)
        return _shade(sf, si)

    @staticmethod
    def backward(ctx, g):
        sf, si = ctx.saved_tensors
        return shade_bwd(sf, si, g.contiguous()), None


def shade_bwd(sf, si, g):
    """VJP of shade + carry in its f32 rows: [NSF, R], [NSI, R] i32,
    [NSO, R] cotangent -> [NSF, R]. The kernel on CUDA tensors,
    ``shade_vjp_plain`` on CPU tensors.

    Kernel note. Replaces ``_shade_bwd_kernel`` (fused.py:505). Bound on
    an H100 80GB HBM3 at 700 W: its chain of dependent operations, not its
    bytes. One thread a ray at 168 registers (one 256-thread block an SM),
    its 75 sums in local memory (a run-time index), ran at 1.7x its copy
    floor. The kernel (csrc/fused.cu ``shade_bwd_kernel``) runs one warp
    a 32-ray tile: lane 0 bulk-copies the tile's 97 row segments into
    shared memory, each lane re-runs the forward from there and sums its
    cotangent in its own column of the tile's f32 rows, each addition in
    a fixed order; registers capped at 128, 16 warps an SM. A ray with no
    hit skips the forward: its VJP is the carry's pass-through
    (``tests/test_torch_fused.py``), which at the last bounce, where
    nearly every warp holds no hit, takes the kernel to its copy floor.
    """
    if not sf.is_cuda:
        return shade_vjp_plain(sf, si, g)
    _check_stack("sf", sf, NSF, torch.float32)
    _check_stack("si", si, NSI, torch.int32, like=sf)
    _check_stack("g", g, NSO, torch.float32, like=sf)
    out = torch.empty_like(sf)
    SHADE_BWD.launch(sf.device, _cuda.ptr(sf), _cuda.ptr(si), _cuda.ptr(g),
                     sf.shape[1], _cuda.ptr(out))
    return out


def shade_vjp_plain(sf, si, g):
    """Plain version of ``shade_bwd``: ``torch.autograd.grad`` of
    ``shade_carry_math`` with cotangent ``g``, the rows read once
    (``_vjp``)."""
    return _vjp(shade_carry_math, sf, g, si)


def stack_copy(f, si=None, n_out=NSO):
    """The copy floor of a shade-family kernel: ([NF, R] f32, [NI, R] i32
    or None) -> [n_out, R], row k the sum of the f32 rows k, k + n_out,
    ... and of the int rows k, k + n_out, ... For measurement only: a
    kernel of the first kernels' launch shape that streams the same stacks
    and does no math (csrc/fused.cu ``stack_copy_kernel``), built for the
    shapes in ``COPY_SHAPES``; ``stack_copy_plain`` on CPU tensors."""
    if not f.is_cuda:
        return stack_copy_plain(f, si, n_out)
    n_int = 0 if si is None else si.shape[0]
    if (f.shape[0], n_int, n_out) not in COPY_SHAPES:
        raise ValueError(f"stack_copy: ({f.shape[0]}, {n_int}, {n_out}) "
                         f"rows is not one of {COPY_SHAPES}")
    _check_stack("f", f, f.shape[0], torch.float32)
    if si is not None:
        _check_stack("si", si, n_int, torch.int32, like=f)
    out = torch.empty((n_out, f.shape[1]), dtype=torch.float32,
                      device=f.device)
    STACK_COPY.launch(f.device, _cuda.ptr(f), f.shape[0],
                      0 if si is None else _cuda.ptr(si), n_int, f.shape[1],
                      _cuda.ptr(out), n_out)
    return out


def stack_copy_plain(f, si=None, n_out=NSO):
    """Plain version of ``stack_copy``, in the kernel's order of sums."""
    out = torch.zeros((n_out, f.shape[1]), dtype=torch.float32,
                      device=f.device)
    for k in range(f.shape[0]):
        out[k % n_out] += f[k]
    for k in range(0 if si is None else si.shape[0]):
        out[k % n_out] += si[k].to(torch.float32)
    return out


def _check_stack(name, x, rows, dtype, like=None):
    ok = (x.ndim == 2 and x.shape[0] == rows and x.dtype == dtype
          and x.is_contiguous())
    if like is not None:
        ok = ok and x.device == like.device and x.shape[1] == like.shape[1]
    if not ok:
        raise ValueError(
            f"{name}: need a contiguous [{rows}, R] {dtype} stack"
            f"{'' if like is None else ' matching the forward stack'}, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device}"
        )
