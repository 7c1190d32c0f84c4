"""The final scene of Shirley's *Ray Tracing in One Weekend* with *The
Next Week*'s moving spheres, as the reference renderer builds it
(swishersnaaake/sexy-raytracer ``main.cpp:92-122``): a checker ground, a
22 x 22 grid of small spheres (diffuse and moving, fuzzy metal, glass) and
three large ones, drawn with the reference's 64-bit LCG in float32, draw
for draw.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenedesc import SceneDesc


def lcg(seed: int):
    """state = state * 6364136223846793005 + 1442695040888963407 mod
    2**64; a draw is the top 24 bits / 2**24, exact in float32."""
    state = seed & 0xFFFFFFFFFFFFFFFF

    def nxt() -> np.float32:
        nonlocal state
        state = (state * 6364136223846793005 + 1442695040888963407) \
            & 0xFFFFFFFFFFFFFFFF
        return np.float32(state >> 40) / np.float32(16777216.0)

    return nxt


def build(params: dict, seed: int) -> SceneDesc:
    """The field of ``params["layout_seed"]``; the run's ``seed`` plays
    no part, so every run renders the same work."""
    f32 = np.float32
    nxt = lcg(int(params["layout_seed"]))
    b = SceneDesc()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = nxt()
            cx = f32(a) + f32(0.9) * nxt()
            cz = f32(bb) + f32(0.9) * nxt()
            center = np.array([cx, 0.2, cz], np.float32)
            delta = center - np.array([4.0, 0.2, 0.0], np.float32)
            if np.sqrt(f32(np.dot(delta, delta))) <= f32(0.9):
                continue
            if choose < f32(0.8):
                r1, r2 = nxt(), nxt()
                g1, g2 = nxt(), nxt()
                b1, b2 = nxt(), nxt()
                mat = b.add_pbr_material(albedo_tex=b.add_solid_texture(
                    (f32(r1 * r2), f32(g1 * g2), f32(b1 * b2))))
                dy = nxt() * f32(0.5)
                center2 = center + np.array([0.0, dy, 0.0], np.float32)
                b.add_sphere(center, 0.2, mat, center1=center2)
            elif choose < f32(0.95):
                ar = f32(0.5) + f32(0.5) * nxt()
                ag = f32(0.5) + f32(0.5) * nxt()
                ab = f32(0.5) + f32(0.5) * nxt()
                fuzz = f32(0.5) * nxt()
                b.add_sphere(center, 0.2,
                             b.add_metal_material((ar, ag, ab), float(fuzz)))
            else:
                b.add_sphere(center, 0.2, b.add_dielectric_material(1.5))
    b.add_sphere((0, 1, 0), 1.0, b.add_dielectric_material(1.5))
    b.add_sphere((-4, 1, 0), 1.0, b.add_pbr_material(
        albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))))
    b.add_sphere((3, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    return b
