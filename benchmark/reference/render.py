"""The plain reference path tracer: the reference renderer's semantics
(swishersnaaake/sexy-raytracer: camera.h, model.h, sphere.h, material.h,
pbr.h, texture.h, main.cpp:33-52 and 209-211) in plain PyTorch, one
operation at a time, with no kernel, no culling and no fused stack.

It takes a scene description (``benchmark/scenedesc.py``) and works out
everything the program derives from it again: the triangle planes and
edge tests, the material rows and slot kinds, the 8-channel texel pack of
every material with an image map. Hit search tests every ray against every
primitive; the last bounce takes the closest hit like every other bounce.
Every float runs in ``dtype``: float32, as the scenes state, or a lower
precision for the control.

It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import rng

T_MIN = 0.001          # main.cpp:39
EPSILON = float(np.finfo(np.float32).eps)
PI = 3.1415926535897932385
BIG = 3.0e38
PBR, METAL, DIELECTRIC, LIGHT = 0, 1, 2, 3


# -- vector helpers ([..., 3], component on the last axis) -------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def maximum(x, c):
    """max(x, c); a tie splits the gradient half and half."""
    return torch.maximum(x, x.new_tensor(c))


def minimum(x, c):
    return torch.minimum(x, x.new_tensor(c))


def clip(x, lo, hi):
    if lo is not None:
        x = maximum(x, lo)
    return x if hi is None else minimum(x, hi)


def safe_sqrt(x, eps=1e-24):
    return torch.sqrt(maximum(x, eps))


def unit(v):
    len2 = dot(v, v)[..., None]
    return torch.where(len2 == 0.0, v, v / safe_sqrt(len2))


def reflect(v, n):
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, ratio):
    cos_theta = minimum(dot(n, -uv), 1.0)
    perp = ratio[..., None] * (uv + cos_theta[..., None] * n)
    par = -safe_sqrt(torch.abs(1.0 - dot(perp, perp)))[..., None] * n
    return perp + par


# -- the scene, worked out from its description ------------------------------

def _resample(img, H, W):
    h, w = img.shape[:2]
    jj = (np.arange(H) * h) // H
    ii = (np.arange(W) * w) // W
    return img[jj[:, None], ii[None, :]]


def scene_arrays(desc, device, dtype=torch.float32) -> dict:
    """Tensors of the scene ``desc`` on ``device``: geometry and material
    rows in ``dtype``, ids and kinds as int64, ``atlas`` the texel pack
    ``[L, H, W, 8]`` (albedo rgb, normal rgb, metallic, roughness; 0-255)."""
    f32 = np.float32
    v0s, v1s, v2s, t0s, t1s, t2s, tm = [], [], [], [], [], [], []
    for pos, uv, idx, mat in desc.meshes:
        v0s.append(pos[idx[:, 0]])
        v1s.append(pos[idx[:, 1]])
        v2s.append(pos[idx[:, 2]])
        t0s.append(uv[idx[:, 0]])
        t1s.append(uv[idx[:, 1]])
        t2s.append(uv[idx[:, 2]])
        tm.append(np.full(idx.shape[0], mat, np.int64))

    def cat(parts, shape):
        return np.concatenate(parts).astype(f32) if parts \
            else np.zeros(shape, f32)

    out = dict(tri_v0=cat(v0s, (0, 3)), tri_v1=cat(v1s, (0, 3)),
               tri_v2=cat(v2s, (0, 3)), tri_uv0=cat(t0s, (0, 2)),
               tri_uv1=cat(t1s, (0, 2)), tri_uv2=cat(t2s, (0, 2)))
    tri_mat = np.concatenate(tm) if tm else np.zeros((0,), np.int64)
    sph = desc.spheres
    out.update(
        sph_c0=np.array([s[0] for s in sph], f32).reshape(-1, 3),
        sph_c1=np.array([s[1] for s in sph], f32).reshape(-1, 3),
        sph_t0=np.array([s[2] for s in sph], f32),
        sph_t1=np.array([s[3] for s in sph], f32),
        sph_r=np.array([s[4] for s in sph], f32))
    sph_mat = np.array([s[5] for s in sph], np.int64)

    texs = desc.textures
    M = len(desc.materials)
    rows = {k: np.zeros((M, n), f32) for k, n in (
        ("base_color", 4), ("albedo_c0", 3), ("albedo_c1", 3),
        ("emit", 3), ("normal_c0", 3), ("normal_c1", 3),
        ("metal_cc", 2), ("rough_cc", 2))}
    scal = {k: np.zeros((M,), f32) for k in
            ("metallic", "roughness", "fuzz", "ior")}
    scal["ior"][:] = 1.0
    kinds = {k: np.zeros((M,), np.int64) for k in
             ("type", "albedo", "normal", "metal", "rough", "layer", "pw",
              "ph")}
    kinds["layer"][:] = -1
    kinds["pw"][:] = 1
    kinds["ph"][:] = 1
    layers = []
    for mi, m in enumerate(desc.materials):
        kind = m["kind"]
        if kind == "metal":
            kinds["type"][mi] = METAL
            rows["base_color"][mi] = (*m["albedo"], 1.0)
            scal["fuzz"][mi] = m["fuzz"]
            continue
        if kind == "dielectric":
            kinds["type"][mi] = DIELECTRIC
            rows["base_color"][mi] = 1.0
            scal["ior"][mi] = m["ior"]
            continue
        if kind == "light":
            kinds["type"][mi] = LIGHT
            rows["emit"][mi] = m["color"]
            continue
        kinds["type"][mi] = PBR
        rows["base_color"][mi] = m["base_color"]
        scal["metallic"][mi] = m["metallic"]
        scal["roughness"][mi] = m["roughness"]
        images = {}
        a = texs[m["albedo"]] if m["albedo"] >= 0 else None
        if a is not None:
            if a["kind"] == "solid":
                # a solid albedo is used as a texel: divided by 255
                kinds["albedo"][mi] = 1
                rows["albedo_c0"][mi] = a["c0"]
            elif a["kind"] == "checker":
                kinds["albedo"][mi] = 2
                rows["albedo_c0"][mi] = a["c0"]
                rows["albedo_c1"][mi] = a["c1"]
            else:
                kinds["albedo"][mi] = 3
                images["albedo"] = a["image"]
        for slot in ("normal", "metal", "rough"):
            if m[slot] < 0:
                continue
            t = texs[m[slot]]
            if t["kind"] == "image":
                kinds[slot][mi] = 3
                images[slot] = t["image"]
                continue
            # a procedural map's value at the hit: a solid colour as it
            # is, a checker's colours times 255
            kinds[slot][mi] = 2
            scale = 255.0 if t["kind"] == "checker" else 1.0
            c0 = np.asarray(t["c0"], f32) * scale
            c1 = np.asarray(t["c1"], f32) * 255.0 \
                if t["kind"] == "checker" else c0
            if slot == "normal":
                rows["normal_c0"][mi], rows["normal_c1"][mi] = c0, c1
            elif slot == "metal":
                rows["metal_cc"][mi] = (c0[0] / 255.0, c1[0] / 255.0)
            else:
                rows["rough_cc"][mi] = (c0[1] / 255.0, c1[1] / 255.0)
        if images:
            H = max(im.shape[0] for im in images.values())
            W = max(im.shape[1] for im in images.values())
            pack = np.zeros((H, W, 8), f32)
            if "albedo" in images:
                pack[..., 0:3] = _resample(images["albedo"], H, W)
            if "normal" in images:
                pack[..., 3:6] = _resample(images["normal"], H, W)
            if "metal" in images:
                pack[..., 6] = _resample(images["metal"], H, W)[..., 0]
            if "rough" in images:
                pack[..., 7] = _resample(images["rough"], H, W)[..., 1]
            kinds["layer"][mi] = len(layers)
            kinds["ph"][mi], kinds["pw"][mi] = H, W
            layers.append(pack)
    if layers:
        Hm = max(p.shape[0] for p in layers)
        Wm = max(p.shape[1] for p in layers)
        atlas = np.zeros((len(layers), Hm, Wm, 8), f32)
        for li, p in enumerate(layers):
            atlas[li, :p.shape[0], :p.shape[1]] = p
    else:
        atlas = np.zeros((1, 1, 1, 8), f32)

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, dtype)
         for k, v in out.items()}
    t.update({f"mat_{k}": torch.from_numpy(v).to(device, dtype)
              for k, v in {**rows, **scal}.items()})
    t.update({f"kind_{k}": torch.from_numpy(v).to(device)
              for k, v in kinds.items()})
    t["tri_mat"] = torch.from_numpy(tri_mat).to(device)
    t["sph_mat"] = torch.from_numpy(sph_mat).to(device)
    t["atlas"] = torch.from_numpy(atlas).to(device, dtype)
    # triangle plane and edge tests: N = (v1 - v0) x (v2 - v0), d = -N.v0,
    # q_i = N x e_i, c_i = q_i . v_i (model.h:125-154)
    v0, v1, v2 = t["tri_v0"], t["tri_v1"], t["tri_v2"]
    n = cross(v1 - v0, v2 - v0)
    q = [cross(n, v1 - v0), cross(n, v2 - v1), cross(n, v0 - v2)]
    t["tri_n"] = n
    t["tri_d"] = -dot(n, v0)
    t["tri_q"] = torch.stack(q, -2)
    t["tri_c"] = torch.stack([dot(q[0], v0), dot(q[1], v1), dot(q[2], v2)],
                             -1)
    return t


# -- camera (camera.h:10-50) --------------------------------------------------

def camera(cfg: dict, aspect: float, device, dtype=torch.float32) -> dict:
    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    eye, look, up = f(cfg["eye"]), f(cfg["look_at"]), f(cfg["up"])
    theta = f(cfg["vfov_degrees"]) * PI / 180.0
    vh = 2.0 * torch.tan(theta / 2.0)
    vw = aspect * vh
    w = unit(eye - look)
    u = unit(cross(up, w))
    v = unit(cross(w, u))
    fd = f(cfg["focus_dist"])
    hor = fd * vw * u
    ver = fd * vh * v
    return dict(origin=eye, lower_left=eye - hor / 2.0 - ver / 2.0 - fd * w,
                horizontal=hor, vertical=ver, u=u, v=v,
                lens_radius=f(cfg["aperture"]) / 2.0,
                time0=f(cfg["time0"]), time1=f(cfg["time1"]))


def camera_rays(cam, s, t, ucam):
    """Rays through viewport ``s``, ``t`` with lens and shutter draws."""
    r = torch.sqrt(ucam[:, 0])
    th = (2.0 * PI) * ucam[:, 1]
    rd0 = cam["lens_radius"] * (r * torch.cos(th))
    rd1 = cam["lens_radius"] * (r * torch.sin(th))
    offset = rd0[:, None] * cam["u"] + rd1[:, None] * cam["v"]
    org = cam["origin"] + offset
    direction = (cam["lower_left"] + s[:, None] * cam["horizontal"]
                 + t[:, None] * cam["vertical"] - cam["origin"] - offset)
    time = cam["time0"] + (cam["time1"] - cam["time0"]) * ucam[:, 2]
    return org, direction, time


# -- closest hit: every ray against every primitive ----------------------------

def sphere_center(sc, idx, time):
    c0, c1 = sc["sph_c0"][idx], sc["sph_c1"][idx]
    t0, t1 = sc["sph_t0"][idx], sc["sph_t1"][idx]
    moving = torch.any(c0 != c1, dim=-1)
    denom = torch.where(t1 == t0, 1.0, t1 - t0)
    frac = (time - t0) / denom
    return torch.where(moving[..., None], c0 + frac[..., None] * (c1 - c0), c0)


@torch.no_grad()
def closest_hit(sc, org, dir, time, t_min, tile=256):
    """Global primitive id of the closest hit (triangles, then spheres;
    -1 for none): triangles back-face culled, the three edge tests at the
    plane hit, ``t >= t_min``; spheres the nearest root ``>= t_min``."""
    R = org.shape[0]
    dt = org.dtype
    T = sc["tri_v0"].shape[0]
    S = sc["sph_c0"].shape[0]
    best_t = torch.full((R,), float("inf"), dtype=dt, device=org.device)
    best_i = torch.full((R,), -1, dtype=torch.int64, device=org.device)
    ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
    dx, dy, dz = dir[:, 0:1], dir[:, 1:2], dir[:, 2:3]
    for s in range(0, T, tile):
        n = sc["tri_n"][s:s + tile]
        q = sc["tri_q"][s:s + tile]
        c = sc["tri_c"][s:s + tile]
        ndir = dx * n[:, 0] + dy * n[:, 1] + dz * n[:, 2]
        a_n = ox * n[:, 0] + oy * n[:, 1] + oz * n[:, 2] + sc["tri_d"][s:s + tile]
        ok = ndir <= -EPSILON
        t = -a_n / torch.where(ok, ndir, -1.0)
        px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
        ok = ok & (t >= t_min[:, None])
        for k in range(3):
            ok = ok & ((q[:, k, 0] * px + q[:, k, 1] * py + q[:, k, 2] * pz
                        - c[:, k]) >= 0.0)
        t = torch.where(ok, t, float("inf"))
        tb, ta = torch.min(t, dim=1)
        better = tb < best_t
        best_t = torch.where(better, tb, best_t)
        best_i = torch.where(better, ta + s, best_i)
    if S:
        for s in range(0, S, tile):
            idx = torch.arange(s, min(s + tile, S), device=org.device)
            center = sphere_center(sc, idx[None, :], time[:, None])
            oc = org[:, None, :] - center
            a = dot(dir, dir)[:, None]
            half_b = dot(oc, dir[:, None, :])
            r = sc["sph_r"][idx][None, :]
            cterm = dot(oc, oc) - r * r
            disc = half_b * half_b - a * cterm
            has = disc >= 0.0
            sq = torch.sqrt(torch.where(has, disc, 0.0))
            sa = torch.where(a == 0.0, 1.0, a)
            r0 = (-half_b - sq) / sa
            r1 = (-half_b + sq) / sa
            ok0 = has & (r0 >= t_min[:, None])
            ok1 = has & (r1 >= t_min[:, None])
            root = torch.where(ok0, r0, torch.where(ok1, r1, float("inf")))
            tb, ta = torch.min(root, dim=1)
            better = tb < best_t
            best_t = torch.where(better, tb, best_t)
            best_i = torch.where(better, T + s + ta, best_i)
    return torch.where(torch.isfinite(best_t), best_i, -1)


# -- the hit record of known winners ------------------------------------------

def _tri_record(sc, org, dir, i):
    v0, v1, v2 = sc["tri_v0"][i], sc["tri_v1"][i], sc["tri_v2"][i]
    uv0, uv1, uv2 = sc["tri_uv0"][i], sc["tri_uv1"][i], sc["tri_uv2"][i]
    n = cross(v1 - v0, v2 - v0)
    ndir = dot(n, dir)
    t = -(dot(n, org) - dot(n, v0)) / torch.where(ndir == 0.0, -1.0, ndir)
    p = org + t[..., None] * dir

    def invdist(v):
        dv = p - v
        return 1.0 / maximum(safe_sqrt(dot(dv, dv)), 1e-20)

    r0, r1, r2 = invdist(v0), invdist(v1), invdist(v2)
    den = r0 + r1 + r2
    r0, r1, r2 = r0 / den, r1 / den, r2 / den
    u = r0 * uv0[..., 0] + r1 * uv1[..., 0] + r2 * uv2[..., 0]
    v = 1.0 - (r0 * uv0[..., 1] + r1 * uv1[..., 1] + r2 * uv2[..., 1])
    uv = torch.stack([u, v], -1).detach()
    out = unit(n)
    front = dot(dir, out) < 0.0
    normal = torch.where(front[..., None], out, -out)
    e0, e1 = v1 - v0, v2 - v0
    d0, d1 = uv1 - uv0, uv2 - uv0
    f = d0[..., 0] * d1[..., 1] - d1[..., 0] * d0[..., 1]
    inv_f = 1.0 / torch.where(f == 0.0, EPSILON, f)
    tangent = unit(inv_f[..., None] * (d1[..., 1:2] * e0 - d0[..., 1:2] * e1))
    bitangent = unit(inv_f[..., None]
                     * (-d1[..., 0:1] * e0 + d0[..., 0:1] * e1))
    return p, normal, tangent, bitangent, uv, front, sc["tri_mat"][i]


def _sph_record(sc, org, dir, time, i, t_min):
    center = sphere_center(sc, i, time)
    r = sc["sph_r"][i]
    oc = org - center
    a = dot(dir, dir)
    half_b = dot(oc, dir)
    c = dot(oc, oc) - r * r
    sq = safe_sqrt(half_b * half_b - a * c)
    sa = torch.where(a == 0.0, 1.0, a)
    r0 = (-half_b - sq) / sa
    r1 = (-half_b + sq) / sa
    t = torch.where(r0 >= t_min, r0, r1)
    p = org + t[..., None] * dir
    out = unit(p - center)
    front = dot(dir, out) < 0.0
    normal = torch.where(front[..., None], out, -out)
    o = out.detach()
    theta = torch.acos(clip(-o[..., 1], -1.0, 1.0))
    phi = torch.atan2(-o[..., 2], o[..., 0]) + PI
    uv = torch.stack([phi / (2.0 * PI), theta / PI], -1)
    pole = (1.0 - torch.abs(out[..., 1])) < EPSILON
    b = torch.where(pole[..., None], out.new_tensor([0.0, 0.0, -1.0]),
                    out.new_tensor([0.0, 1.0, 0.0]))
    tangent = unit(cross(b, out))
    bitangent = unit(cross(out, tangent))
    return p, normal, tangent, bitangent, uv, front, sc["sph_mat"][i]


def hit_record(sc, org, dir, time, prim, t_min):
    T = sc["tri_v0"].shape[0]
    S = sc["sph_c0"].shape[0]
    hit = prim >= 0
    is_tri = hit & (prim < T)
    parts = []
    if T:
        parts.append(_tri_record(sc, org, dir,
                                 torch.where(is_tri, prim, 0).clamp(0, T - 1)))
    if S:
        parts.append(_sph_record(sc, org, dir, time,
                                 (prim - T).clamp(0, S - 1), t_min))
    if len(parts) == 2:
        rec = tuple(torch.where(is_tri.reshape(is_tri.shape + (1,) * (a.ndim - 1)),
                                a, b) for a, b in zip(*parts))
    else:
        rec = parts[0]
    p, normal, tangent, bitangent, uv, front, mat = rec
    return dict(p=p, normal=normal, tangent=tangent, bitangent=bitangent,
                uv=uv, front=front & hit, mat=torch.where(hit, mat, 0),
                hit=hit)


# -- materials (material.h, pbr.h, texture.h) ----------------------------------

def shade(sc, atlas, rec, ray_dir, u):
    """(attenuation, emitted, next direction, scattered) of each hit;
    ``u`` [R, 6] the bounce's draws."""
    m = rec["mat"]
    g = {k[4:]: v[m] for k, v in sc.items() if k.startswith("mat_")}
    kd = {k[5:]: v[m] for k, v in sc.items() if k.startswith("kind_")}
    mtype = kd["type"]

    # one texel of the material's pack: nearest, u clamped, v flipped
    L, H, W, C = atlas.shape
    uu = clip(rec["uv"][..., 0], 0.0, 1.0)
    vv = 1.0 - clip(rec["uv"][..., 1], 0.0, 1.0)
    xi = torch.minimum((uu * kd["pw"]).to(torch.int64), kd["pw"] - 1)
    yj = torch.minimum((vv * kd["ph"]).to(torch.int64), kd["ph"] - 1)
    flat = (kd["layer"].clamp(min=0) * H + yj) * W + xi
    pack = atlas.reshape(L * H * W, C)[flat]

    p = rec["p"]
    odd = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
           * torch.sin(10.0 * p[..., 2])) < 0.0
    base = g["base_color"][..., :3]

    # pbrMetallicRoughness
    ak = kd["albedo"]
    checker = torch.where(odd[..., None], g["albedo_c1"], g["albedo_c0"]) * 255.0
    mv = torch.where((ak == 1)[..., None], g["albedo_c0"], pack[..., 0:3])
    mv = torch.where((ak == 2)[..., None], checker, mv)
    albedo = torch.where((ak == 0)[..., None], base, mv / 255.0)
    nk = kd["normal"]
    nv = torch.where((nk == 2)[..., None],
                     torch.where(odd[..., None], g["normal_c1"], g["normal_c0"]),
                     pack[..., 3:6])
    nm = (nv - 128.0) / 128.0
    world = (rec["tangent"] * nm[..., 0:1] + rec["bitangent"] * nm[..., 1:2]
             + rec["normal"] * nm[..., 2:3])
    normal = torch.where((nk != 0)[..., None], unit(world), rec["normal"])
    mk = kd["metal"]
    met = torch.where(mk == 3, pack[..., 6] / 255.0, g["metallic"])
    met = clip(torch.where(mk == 2, torch.where(odd, g["metal_cc"][..., 1],
                                                g["metal_cc"][..., 0]), met),
               0.0, 1.0)
    met = torch.where(mk == 0, g["metallic"], met)
    rk = kd["rough"]
    rough = torch.where(rk == 3, pack[..., 7] / 255.0, g["roughness"])
    rough = clip(torch.where(rk == 2, torch.where(odd, g["rough_cc"][..., 1],
                                                  g["rough_cc"][..., 0]), rough),
                 0.0, 1.0)
    rough = torch.where(rk == 0, g["roughness"], rough)

    z = 1.0 - 2.0 * u[:, 0]
    rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    ph = (2.0 * PI) * u[:, 1]
    on_sphere = torch.stack([rr * torch.cos(ph), rr * torch.sin(ph), z], -1)
    z2 = 1.0 - 2.0 * u[:, 2]
    rr2 = torch.sqrt(torch.clamp(1.0 - z2 * z2, min=0.0))
    ph2 = (2.0 * PI) * u[:, 3]
    in_ball = torch.stack([rr2 * torch.cos(ph2), rr2 * torch.sin(ph2), z2],
                          -1) * (u[:, 4] ** (1.0 / 3.0))[:, None]

    sdir = normal + on_sphere
    degenerate = torch.all(torch.abs(sdir) < 1e-8, dim=-1)
    sdir = unit(torch.where(degenerate[..., None], normal, sdir))
    view = -unit(ray_dir)
    half = unit(sdir + view)
    ndl = maximum(dot(normal, sdir), 0.0)
    ndh = maximum(dot(normal, half), 0.0)
    hdv = maximum(dot(half, view), 0.0)
    ndv = maximum(dot(normal, view), 0.0)
    f0 = (1.0 - met[..., None]) * 0.4 + met[..., None] * base
    a2 = (rough * rough) * (rough * rough)
    qd = ndh * ndh * (a2 - 1.0) + 1.0
    ndf = a2 / maximum(PI * (qd * qd), 1e-12)
    fres = f0 + (1.0 - f0) * torch.exp2((-5.55473 * hdv - 6.98316) * hdv)[..., None]
    k = ((rough + 1.0) * (rough + 1.0)) / 8.0
    gaf = (ndl / (ndl * (1.0 - k) + k)) * (ndv / (ndv * (1.0 - k) + k))
    diffuse = (albedo / PI) * (1.0 - fres) * (1.0 - met[..., None]) * base
    spec = (ndf * gaf)[..., None] * fres / (4.0 * ndv * ndl + EPSILON)[..., None]
    pbr_att = (diffuse + spec) * ndl[..., None]

    # metal
    mdir = reflect(unit(ray_dir), rec["normal"]) + g["fuzz"][..., None] * in_ball
    m_ok = dot(mdir, rec["normal"]) > 0.0

    # dielectric
    ratio = torch.where(rec["front"], 1.0 / g["ior"], g["ior"])
    ud = unit(ray_dir)
    cos_t = minimum(dot(rec["normal"], -ud), 1.0)
    sin_t = torch.sqrt(maximum(1.0 - cos_t * cos_t, 0.0))
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    x = 1.0 - cos_t
    refl = r0 + (1.0 - r0) * (x * ((x * x) * (x * x)))
    do_refl = (ratio * sin_t > 1.0) | (refl > u[:, 5])
    ddir = torch.where(do_refl[..., None], reflect(ud, rec["normal"]),
                       refract(ud, rec["normal"], ratio))

    emitted = torch.where((mtype == LIGHT)[..., None], g["emit"], 0.0)
    zero = torch.zeros_like(pbr_att)
    att = torch.where((mtype == PBR)[..., None], pbr_att, zero)
    att = torch.where((mtype == METAL)[..., None], base, att)
    att = torch.where((mtype == DIELECTRIC)[..., None], torch.ones_like(att), att)
    direction = torch.where((mtype == PBR)[..., None], sdir, ray_dir)
    direction = torch.where((mtype == METAL)[..., None], mdir, direction)
    direction = torch.where((mtype == DIELECTRIC)[..., None], ddir, direction)
    scattered = (mtype == PBR) | ((mtype == METAL) & m_ok) | (mtype == DIELECTRIC)
    return att, emitted, direction, scattered & rec["hit"]


# -- the integrator (main.cpp:33-52 as bounce steps) ----------------------------

def trace(sc, atlas, org, dir, time, keys, background, max_bounce):
    """Radiance of each path: emission and the background on a miss,
    weighted by the throughput; ``max_bounce`` hit searches. Differentiable
    in ``atlas``."""
    R = org.shape[0]
    dt = org.dtype
    thr = torch.ones((R, 3), dtype=dt, device=org.device)
    rad = torch.zeros((R, 3), dtype=dt, device=org.device)
    alive = torch.ones((R,), dtype=torch.bool, device=org.device)
    for b in range(max_bounce):
        t_min = torch.where(alive, T_MIN, BIG).to(dt)
        prim = closest_hit(sc, org.detach(), dir.detach(), time, t_min)
        rec = hit_record(sc, org, dir, time, prim, t_min)
        u = rng.uniforms(rng.fold_in(keys, 100 + b), 6).to(dt)
        att, emitted, ndir, scattered = shade(sc, atlas, rec, dir, u)
        miss = alive & ~rec["hit"]
        rad = rad + torch.where(miss[:, None], thr * background, 0.0)
        rad = rad + torch.where((alive & rec["hit"])[:, None], thr * emitted,
                                0.0)
        nxt = alive & rec["hit"] & scattered
        thr = torch.where(nxt[:, None], thr * att, thr)
        org = torch.where(nxt[:, None], rec["p"], org)
        dir = torch.where(nxt[:, None], ndir, dir)
        alive = nxt
    return rad


def render_pixels(sc, atlas, cam, pixel_ids, base_key, *, width, height, spb,
                  max_bounce, background, block=131072):
    """Radiance summed over samples ``0 .. spb - 1`` of each pixel id
    ``[C]`` -> ``[C, 3]``: pixel ``x = id % width``, ``y = id // width``,
    viewport ``u = (x + r) / (W - 1)``, ``v = ((H - y) + r) / (H - 1)``
    (main.cpp:209-211), one key per (pixel, sample). Traced in blocks of
    ``block`` paths."""
    dt = sc["tri_v0"].dtype
    dev = pixel_ids.device
    bg = torch.as_tensor(background, dtype=dt, device=dev)
    per = max(1, block // spb)
    out = []
    for c0 in range(0, pixel_ids.shape[0], per):
        ids = pixel_ids[c0:c0 + per].to(torch.int64)
        C = ids.shape[0]
        pid = ids.repeat_interleave(spb)
        sid = torch.arange(spb, dtype=torch.int64, device=dev).repeat(C)
        keys = rng.ray_keys(base_key, pid, sid)
        ucam = rng.uniforms(keys, 5).to(dt)
        x = (pid % width).to(dt)
        y = (pid // width).to(dt)
        s = (x + ucam[:, 0]) / (width - 1)
        t = ((height - y) + ucam[:, 1]) / (height - 1)
        org, dirn, time = camera_rays(cam, s, t, ucam[:, 2:5])
        rad = trace(sc, atlas, org, dirn, time, keys, bg, max_bounce)
        out.append(rad.reshape(C, spb, 3).sum(dim=1))
    return torch.cat(out)


def resolve(rad_sum, spp):
    """Gamma-2 resolve clamped to [0, 0.999] (color.h:30-39)."""
    return clip(torch.sqrt(clip(rad_sum / spp, 1e-8, None)), 0.0, 0.999)

