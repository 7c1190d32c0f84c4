"""The Cornell box of Shirley's *Ray Tracing: The Next Week* (chapter
"Cornell Box", ``cornell_box()``): five walls, a quad light under the
ceiling and two white boxes turned about y, in the book's order.

The book's lambertian colours become ``pbrMetallicRoughness`` materials
at metallic 0 and roughness 0 with the colour as their colour factor and
no albedo map: the program and the plain reference read such a material
at its factor, where they divide a solid albedo map by 255 as the
reference renderer does (``material.h:163-167``), which would leave the
room black but for the light. A quad ``(Q, u, v)`` is one mesh of two
triangles, ``(Q, Q+u, Q+u+v)`` and ``(Q, Q+u+v, Q+v)``, with uvs (0,0),
(1,0), (1,1), (0,1). The program's find kernels and the plain reference
cull back faces, so every triangle is wound to face where rays come from:
the walls and the light into the room, the box faces out of their box.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenedesc import SceneDesc

RED = (0.65, 0.05, 0.05)
WHITE = (0.73, 0.73, 0.73)
GREEN = (0.12, 0.45, 0.15)
LIGHT = (15.0, 15.0, 15.0)
ROOM_CENTRE = (277.5, 277.5, 277.5)
QUAD_UVS = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)


def quad(b: SceneDesc, q, u, v, mat, towards) -> None:
    """The quad ``(q, u, v)`` as one mesh, wound so that its front face
    looks towards the point ``towards``."""
    q, u, v = (np.asarray(x, np.float64) for x in (q, u, v))
    pos = np.stack([q, q + u, q + u + v, q + v])
    idx = np.array([[0, 1, 2], [0, 2, 3]])
    if np.dot(np.cross(u, v), np.asarray(towards, np.float64) - q) < 0.0:
        idx = idx[:, [0, 2, 1]]
    b.add_mesh(pos, QUAD_UVS, idx, mat)


def box(b: SceneDesc, size, degrees, offset, mat) -> None:
    """The book's ``box((0,0,0), size)``: its six quads, turned by
    ``rotate_y(degrees)`` (x' = cos x + sin z, z' = -sin x + cos z) and
    moved by ``offset``, each facing out of the box."""
    dx = np.array([size[0], 0.0, 0.0])
    dy = np.array([0.0, size[1], 0.0])
    dz = np.array([0.0, 0.0, size[2]])
    lo, hi = np.zeros(3), np.asarray(size, np.float64)
    sides = [((lo[0], lo[1], hi[2]), dx, dy),    # front
             ((hi[0], lo[1], hi[2]), -dz, dy),   # right
             ((hi[0], lo[1], lo[2]), -dx, dy),   # back
             ((lo[0], lo[1], lo[2]), dz, dy),    # left
             ((lo[0], hi[1], hi[2]), dx, -dz),   # top
             ((lo[0], lo[1], lo[2]), dx, dz)]    # bottom
    th = np.deg2rad(degrees)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    off = np.asarray(offset, np.float64)
    centre = rot @ (hi / 2.0) + off
    for q, u, v in sides:
        q = rot @ np.asarray(q, np.float64) + off
        u, v = rot @ u, rot @ v
        # out of the box: towards the mirror image of the centre
        quad(b, q, u, v, mat, 2.0 * q - centre + u + v)


def build(params: dict, seed: int) -> SceneDesc:
    """The book's room; ``params`` may replace the colours (``red``,
    ``white``, ``green``, ``light``). ``seed`` plays no part."""
    b = SceneDesc()
    red, white, green = (
        b.add_pbr_material(base_color=(*params.get(k, d), 1.0))
        for k, d in (("red", RED), ("white", WHITE), ("green", GREEN)))
    light = b.add_light_material(tuple(params.get("light", LIGHT)))
    inside = ROOM_CENTRE
    quad(b, (555, 0, 0), (0, 555, 0), (0, 0, 555), green, inside)
    quad(b, (0, 0, 0), (0, 555, 0), (0, 0, 555), red, inside)
    quad(b, (343, 554, 332), (-130, 0, 0), (0, 0, -105), light, inside)
    quad(b, (0, 0, 0), (555, 0, 0), (0, 0, 555), white, inside)
    quad(b, (555, 555, 555), (-555, 0, 0), (0, 0, -555), white, inside)
    quad(b, (0, 0, 555), (555, 0, 0), (0, 555, 0), white, inside)
    box(b, (165, 330, 165), 15.0, (265, 0, 295), white)
    box(b, (165, 165, 165), -18.0, (130, 0, 65), white)
    return b
