"""Quirk-faithful scalar numpy transcription of the reference tracer
(counterpart of ``sexy_raytracer_tpu/oracle/reference.py``; it reads a
port ``SceneData`` through one move of its tensors to the host).

Used ONLY by tests (SURVEY §7.6): every behavioral quirk of the C++ reference
is reproduced here so device kernels can be validated allclose against a
known-equivalent oracle, and intentional divergences stay measurable.

Quirk ledger (each is deliberate and cited):
  * triangle hit ignores tMax — only ``t < tMin`` rejects (model.h:128-129),
    so in list/BVH traversal a farther triangle can overwrite a nearer hit
    depending on traversal order;
  * triangle back-face culling (model.h:122-123) and parallel-epsilon reject
    (model.h:119-120);
  * inverse-distance "barycentric" weights + flipped v (model.h:157-169);
  * sphere outward normal unnormalized by radius (sphere.h:76);
  * AABB slab test with no div-by-zero guard (aabb.h:13-24);
  * textures return 0-255-scale colors; solid colors pass through unscaled;
    checker multiplies by 255 (texture.h:42-48,147) — so a solid-color PBR
    albedo is effectively divided by 255 in scatter (material.h:165-167);
  * F0 = lerp(0.4, albedoFactor, metalness) (material.h:228);
  * diffuse term multiplies the albedo *factor* twice for textured
    materials (material.h:234-237);
  * metallic from red, roughness from green texture channel (material.h:191,197).

RNG is injected (``rng()`` -> U[0,1) float) so tests can control sequences;
the reference's own stream is an unseeded mt19937 (globals.h:30-35).
"""

from __future__ import annotations

import numpy as np

from sexy_raytracer_tpu_torch.models.scene import (
    MAT_DIELECTRIC,
    MAT_LIGHT,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
)

EPSILON = float(np.finfo(np.float32).eps)
PI = 3.1415926535897932385


def _unit(v):
    n = np.sqrt(float(v @ v))
    return v if n == 0.0 else v / n


class HitRec:
    __slots__ = ("p", "normal", "tangent", "bitangent", "uv", "t", "front_face", "mat_id")


def ray_at(o, d, t):
    return o + t * d


# -- primitive hits ---------------------------------------------------------

def aabb_hit(bmin, bmax, o, d, t_min, t_max):
    """Slab test (aabb.h:11-27). Relies on IEEE inf semantics like the ref."""
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis in range(3):
            inv0 = (bmin[axis] - o[axis]) / d[axis]
            inv1 = (bmax[axis] - o[axis]) / d[axis]
            t0 = min(inv0, inv1)
            t1 = max(inv0, inv1)
            t_min = max(t0, t_min)
            t_max = min(t1, t_max)
            if t_max <= t_min:
                return False
    return True


def sphere_center(scene, s, time):
    c0 = np.asarray(scene.sph_c0[s], np.float64)
    c1 = np.asarray(scene.sph_c1[s], np.float64)
    if np.any(c0 != c1):
        t0, t1 = float(scene.sph_t0[s]), float(scene.sph_t1[s])
        return c0 + ((time - t0) / (t1 - t0)) * (c1 - c0)
    return c0


def sphere_hit(scene, s, o, d, time, t_min, t_max):
    """reference sphere.h:54-83."""
    center = sphere_center(scene, s, time)
    r = float(scene.sph_radius[s])
    oc = o - center
    a = float(d @ d)
    half_b = float(oc @ d)
    c = float(oc @ oc) - r * r
    disc = half_b * half_b - a * c
    if disc < 0.0:
        return None
    sqrtd = np.sqrt(disc)
    root = (-half_b - sqrtd) / a
    if root < t_min or root > t_max:
        root = (-half_b + sqrtd) / a
        if root < t_min or root > t_max:
            return None
    rec = HitRec()
    rec.t = root
    rec.p = ray_at(o, d, root)
    outward = _unit(rec.p - center)  # sphere.h:76 — no /radius
    rec.front_face = float(d @ outward) < 0.0
    rec.normal = outward if rec.front_face else -outward
    theta = np.arccos(np.clip(-outward[1], -1.0, 1.0))
    phi = np.arctan2(-outward[2], outward[0]) + PI
    rec.uv = np.array([phi / (2.0 * PI), theta / PI])
    # tangent basis (sphere.h:96-106)
    b = (
        np.array([0.0, 0.0, -1.0])
        if 1.0 - abs(outward[1]) < EPSILON
        else np.array([0.0, 1.0, 0.0])
    )
    rec.tangent = _unit(np.cross(b, outward))
    rec.bitangent = _unit(np.cross(outward, rec.tangent))
    rec.mat_id = int(scene.sph_mat[s])
    return rec


def triangle_hit(scene, i, o, d, t_min, t_max):
    """reference model.h:104-181 — note t_max is accepted but IGNORED
    (model.h:128-129 quirk)."""
    v = [
        np.asarray(scene.tri_v0[i], np.float64),
        np.asarray(scene.tri_v1[i], np.float64),
        np.asarray(scene.tri_v2[i], np.float64),
    ]
    uvs = [
        np.asarray(scene.tri_uv0[i], np.float64),
        np.asarray(scene.tri_uv1[i], np.float64),
        np.asarray(scene.tri_uv2[i], np.float64),
    ]
    normal = np.cross(v[1] - v[0], v[2] - v[0])
    n_dot_dir = float(normal @ d)
    if abs(n_dot_dir) < EPSILON:
        return None
    if float(d @ normal) > 0.0:  # back-face cull (model.h:122)
        return None
    dd = -float(normal @ v[0])
    t = -(float(normal @ o) + dd) / n_dot_dir
    if t < t_min:  # no t > t_max check (model.h:128)
        return None
    p = ray_at(o, d, t)
    for k in range(3):
        edge = v[(k + 1) % 3] - v[k]
        vp = p - v[k]
        if float(normal @ np.cross(edge, vp)) < 0.0:
            return None
    # inverse-distance "barycentrics" (model.h:157-166)
    dist = [np.linalg.norm(p - vk) for vk in v]
    inv = [1.0 / dk for dk in dist]
    denom = sum(inv)
    r = [ik / denom for ik in inv]
    u = sum(r[k] * uvs[k][0] for k in range(3))
    vv = 1.0 - sum(r[k] * uvs[k][1] for k in range(3))

    rec = HitRec()
    rec.t = t
    rec.p = p
    outward = _unit(normal)
    rec.front_face = float(d @ outward) < 0.0
    rec.normal = outward if rec.front_face else -outward
    rec.uv = np.array([u, vv])
    # tangent basis (model.h:214-235)
    e0 = v[1] - v[0]
    e1 = v[2] - v[0]
    duv0 = uvs[1] - uvs[0]
    duv1 = uvs[2] - uvs[0]
    f = duv0[0] * duv1[1] - duv1[0] * duv0[1]
    if f == 0.0:
        f += EPSILON
    f = 1.0 / f
    rec.tangent = _unit(f * (duv1[1] * e0 - duv0[1] * e1))
    rec.bitangent = _unit(f * (-duv1[0] * e0 + duv0[0] * e1))
    rec.mat_id = int(scene.tri_mat[i])
    return rec


# -- textures ---------------------------------------------------------------

def texture_value(scene, tex_id, u, v, p):
    """reference texture.h value() dispatch, 0-255 reference scale."""
    ttype = int(scene.tex_type[tex_id])
    if ttype == TEX_CHECKER:
        sines = np.sin(10.0 * p[0]) * np.sin(10.0 * p[1]) * np.sin(10.0 * p[2])
        c = scene.tex_color1[tex_id] if sines < 0 else scene.tex_color0[tex_id]
        return np.asarray(c, np.float64) * 255.0
    if ttype == TEX_IMAGE:
        w = int(scene.tex_w[tex_id])
        h = int(scene.tex_h[tex_id])
        layer = int(scene.tex_layer[tex_id])
        uu = min(max(u, 0.0), 1.0)
        vv = 1.0 - min(max(v, 0.0), 1.0)
        i = min(int(uu * w), w - 1)
        j = min(int(vv * h), h - 1)
        return np.asarray(scene.atlas[layer, j, i], np.float64)
    return np.asarray(scene.tex_color0[tex_id], np.float64)


# -- materials --------------------------------------------------------------

def _trowbridge_reitz(n_dot_h, roughness):
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    denom = PI * (n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0) ** 2
    return alpha2 / denom


def _schlick_gaf(n_dot_v, roughness):
    k = ((roughness + 1.0) ** 2) / 8.0
    return n_dot_v / (n_dot_v * (1.0 - k) + k)


def _fresnel_epic(f0, h_dot_v):
    power = 2.0 ** ((-5.55473 * h_dot_v - 6.98316) * h_dot_v)
    return f0 + (1.0 - f0) * power


def random_in_unit_sphere(rng):
    while True:
        p = np.array([rng() * 2 - 1, rng() * 2 - 1, rng() * 2 - 1])
        if float(p @ p) < 1.0:
            return p


def random_unit_vector(rng):
    return _unit(random_in_unit_sphere(rng))


def scatter(scene, mat_id, ray_d, ray_time, rec, rng, samples=None):
    """reference material.h scatter dispatch.

    Returns (ok, attenuation, new_origin, new_dir) — new ray keeps the time.
    ``samples`` optionally injects the random draws for deterministic
    kernel-vs-oracle comparison: keys 'unit_vector' [3], 'unit_sphere' [3],
    'uniform' scalar.
    """
    mtype = int(scene.mat_type[mat_id])

    def draw_unit_vector():
        if samples is not None:
            return np.asarray(samples["unit_vector"], np.float64)
        return random_unit_vector(rng)

    def draw_unit_sphere():
        if samples is not None:
            return np.asarray(samples["unit_sphere"], np.float64)
        return random_in_unit_sphere(rng)

    def draw_uniform():
        if samples is not None:
            return float(samples["uniform"])
        return rng()

    if mtype == MAT_LIGHT:
        return False, None, None, None

    if mtype == MAT_METAL:
        albedo = np.asarray(scene.mat_base_color[mat_id][:3], np.float64)
        fuzz = float(scene.mat_fuzz[mat_id])
        reflected = _reflect(_unit(ray_d), rec.normal)
        new_d = reflected + fuzz * draw_unit_sphere()
        ok = float(new_d @ rec.normal) > 0.0
        return ok, albedo, rec.p, new_d

    if mtype == MAT_DIELECTRIC:
        ir = float(scene.mat_ior[mat_id])
        ratio = (1.0 / ir) if rec.front_face else ir
        unit_d = _unit(ray_d)
        cos_theta = min(float(rec.normal @ -unit_d), 1.0)
        sin_theta = np.sqrt(max(1.0 - cos_theta * cos_theta, 0.0))
        cannot = ratio * sin_theta > 1.0
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
        if cannot or reflectance > draw_uniform():
            new_d = _reflect(unit_d, rec.normal)
        else:
            new_d = _refract(unit_d, rec.normal, ratio)
        return True, np.ones(3), rec.p, new_d

    # MAT_PBR (material.h:156-245)
    base = np.asarray(scene.mat_base_color[mat_id], np.float64)
    albedo_tex = int(scene.mat_albedo_tex[mat_id])
    if albedo_tex >= 0:
        attenuation = texture_value(scene, albedo_tex, rec.uv[0], rec.uv[1], rec.p) / 255.0
    else:
        attenuation = base[:3].copy()

    normal_tex = int(scene.mat_normal_tex[mat_id])
    if normal_tex >= 0:
        nm = texture_value(scene, normal_tex, rec.uv[0], rec.uv[1], rec.p)
        nm = (nm - 128.0) / 128.0
        world = nm[0] * rec.tangent + nm[1] * rec.bitangent + nm[2] * rec.normal
        normal = _unit(world)
    else:
        normal = rec.normal

    metallic_tex = int(scene.mat_metallic_tex[mat_id])
    if metallic_tex >= 0:
        m = float(
            np.clip(
                texture_value(scene, metallic_tex, rec.uv[0], rec.uv[1], rec.p)[0] / 255.0,
                0.0,
                1.0,
            )
        )
    else:
        m = float(scene.mat_metallic[mat_id])

    roughness_tex = int(scene.mat_roughness_tex[mat_id])
    if roughness_tex >= 0:
        r = float(
            np.clip(
                texture_value(scene, roughness_tex, rec.uv[0], rec.uv[1], rec.p)[1] / 255.0,
                0.0,
                1.0,
            )
        )
    else:
        r = float(scene.mat_roughness[mat_id])

    scatter_dir = normal + draw_unit_vector()
    if np.all(np.abs(scatter_dir) < 1e-8):
        scatter_dir = normal
    scatter_dir = _unit(scatter_dir)

    view = -_unit(ray_d)
    half = _unit(scatter_dir + view)
    n_dot_l = max(float(normal @ scatter_dir), 0.0)
    n_dot_h = max(float(normal @ half), 0.0)
    h_dot_v = max(float(half @ view), 0.0)
    n_dot_v = max(float(normal @ view), 0.0)

    f0 = (1.0 - m) * 0.4 + m * base[:3]
    dterm = _trowbridge_reitz(n_dot_h, r)
    fterm = _fresnel_epic(f0, h_dot_v)
    gterm = _schlick_gaf(n_dot_l, r) * _schlick_gaf(n_dot_v, r)

    diffuse = (attenuation / PI) * (1.0 - fterm) * (1.0 - m) * base[:3]
    specular = dterm * fterm * gterm / (4.0 * n_dot_v * n_dot_l + EPSILON)
    attenuation = (diffuse + specular) * n_dot_l
    return True, attenuation, rec.p, scatter_dir


def emitted(scene, mat_id, uv, p):
    if int(scene.mat_type[mat_id]) == MAT_LIGHT:
        tex = int(scene.mat_emit_tex[mat_id])
        if tex >= 0:
            return texture_value(scene, tex, uv[0], uv[1], p)
    return np.zeros(3)


def _reflect(v, n):
    return v - 2.0 * float(v @ n) * n


def _refract(uv, n, ratio):
    cos_theta = min(float(n @ -uv), 1.0)
    out_perp = ratio * (uv + cos_theta * n)
    out_par = -np.sqrt(abs(1.0 - float(out_perp @ out_perp))) * n
    return out_perp + out_par


class Oracle:
    """Scalar reference tracer over a (numpy-viewed) SceneData."""

    def __init__(self, scene, rng=None):
        self.scene = _as_numpy(scene)
        self.rng = rng if rng is not None else np.random.default_rng(0).random

    # linear closest-hit scan, reference hittablelist.h:33-47 (triangles
    # get — and ignore — the shrinking closest bound)
    def hit(self, o, d, time, t_min=0.001, t_max=np.inf):
        scene = self.scene
        closest = t_max
        rec = None
        T = scene.tri_v0.shape[0]
        for i in range(T):
            got = triangle_hit(scene, i, o, d, t_min, closest)
            if got is not None:
                rec = got
                closest = got.t
        for s in range(scene.sph_c0.shape[0]):
            got = sphere_hit(scene, s, o, d, time, t_min, closest)
            if got is not None:
                rec = got
                closest = got.t
        return rec

    def ray_color(self, o, d, time, background, depth):
        """reference main.cpp:33-52."""
        if depth <= 0:
            return np.zeros(3)
        rec = self.hit(o, d, time)
        if rec is None:
            return np.asarray(background, np.float64)
        emit = emitted(self.scene, rec.mat_id, rec.uv, rec.p)
        ok, att, new_o, new_d = scatter(self.scene, rec.mat_id, d, time, rec, self.rng)
        if not ok:
            return emit
        return emit + att * self.ray_color(new_o, new_d, time, background, depth - 1)


def _as_numpy(scene):
    """A port ``SceneData`` (tensors on any device) or a NamedTuple of
    arrays -> the same fields as numpy arrays."""
    if hasattr(scene, "numpy"):
        return scene.numpy()
    return type(scene)(*(np.asarray(a) for a in scene))
