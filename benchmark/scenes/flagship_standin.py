"""The reference renderer's flagship scene (swishersnaaake/sexy-raytracer
``main.cpp:54-154``) with a substitute in the Master Chief mesh's place,
which no file of the repository holds: a procedural heightfield relief of
``2 n**2`` triangles (3,042 at ``n = 39``, as the program's
``presets.flagship_standin`` builds it), a synthetic image albedo and
image normal map made in memory, then the checker
ground, the HDR light, the iron sphere (its four texture files are missing
in the reference's own data, so they render as the magenta sentinel) and
the mirror sphere.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenedesc import SceneDesc

EYE = (0.0, 3.0, 5.0)


def relief(b: SceneDesc, n: int) -> None:
    """The heightfield ``2 sin(0.4x) cos(0.3z) + 0.5 sin(1.7x)`` on an
    ``n x n`` quad grid over [-30, 30]^2, stood upright, scaled to 3 x 3
    units around (0, 2.5, 0), every face wound towards the eye."""
    xs = np.linspace(-30.0, 30.0, n + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 2.0 * np.sin(X * 0.4) * np.cos(Z * 0.3) + 0.5 * np.sin(X * 1.7)
    s = 1.5 / 30.0
    verts = np.stack([X * s, 2.5 - Z * s, Y * s], axis=-1).reshape(-1, 3)
    gi, gj = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    uvs = np.stack([gi / n, gj / n], axis=-1).reshape(-1, 2)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (ii * (n + 1) + jj).ravel()
    c = a + (n + 1)
    idx = np.concatenate(
        [np.stack([a, a + 1, c], 1), np.stack([a + 1, c + 1, c], 1)])
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    normal = np.cross(v1 - v0, v2 - v0)
    to_eye = np.array(EYE) - (v0 + v1 + v2) / 3.0
    away = np.sum(normal * to_eye, axis=1) < 0.0
    idx[away] = idx[away][:, [0, 2, 1]]

    ki, kj = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    albedo = (np.stack([ki, kj, ki ^ kj], axis=-1) * 8).astype(np.uint8)
    ang = (2.0 * np.pi / 32.0) * np.stack([ki, kj], axis=-1)
    normal_map = np.concatenate(
        [128.0 + 40.0 * np.sin(ang), np.full((32, 32, 1), 240.0)], axis=-1
    ).astype(np.uint8)
    mat = b.add_pbr_material(
        albedo_tex=b.add_image_texture(albedo),
        normal_tex=b.add_image_texture(normal_map),
        base_color=(0.9, 0.8, 0.7, 1.0), metallic=0.2, roughness=0.5)
    b.add_mesh(verts, uvs, idx, mat)


def build(params: dict, seed: int) -> SceneDesc:
    """The scene; ``seed`` plays no part (the layout is fixed)."""
    b = SceneDesc()
    relief(b, int(params["relief_n"]))
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    ground = b.add_pbr_material(albedo_tex=checker)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground, time0=0.0, time1=1.0)
    light = b.add_light_material(color=(250.2, 220.9, 110.2))
    b.add_sphere((-7.0, 4.0, 6.0), 1.0, light)
    iron = b.add_pbr_material(
        albedo_tex=b.add_image_texture(None),
        normal_tex=b.add_image_texture(None),
        metallic_tex=b.add_image_texture(None),
        roughness_tex=b.add_image_texture(None),
        base_color=(1.0, 1.0, 1.0, 1.0))
    b.add_sphere((-3.0, 1.0, 0.0), 1.0, iron)
    metal = b.add_metal_material((0.7, 0.6, 0.5), 0.0)
    b.add_sphere((3.0, 1.0, 0.0), 1.0, metal)
    return b
