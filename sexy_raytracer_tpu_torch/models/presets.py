"""The BASELINE scenes as named presets (counterpart of
``models/presets.py``), and the flagship stand-in.

Each preset returns ``(SceneData, RenderConfig)``, the scene on
``device``: the card unless the caller asks for ``"cpu"``. ``PRESETS``
names the JAX package's eight presets. The glTF presets (``cube``,
``square``, ``scene``, ``masterchief``, ``masterchief_glb``) read their
asset through ``models/gltf.py`` and raise, as the JAX package's do, when
it is absent; the Master Chief asset is not in the repository, so
``flagship_standin`` puts a procedural relief mesh with the chief's
triangle count in the chief's place. ``flagship_standin`` has no JAX
counterpart and stays outside ``PRESETS``.

Asset files are read from ``data_dir`` (default: ``$SRT_DATA_DIR``, else
``data/`` at the repository root). A missing texture file yields the
reference's magenta sentinel texture, as in the reference itself.
"""

from __future__ import annotations

import os

import numpy as np

from sexy_raytracer_tpu_torch.models.gltf import load_gltf
from sexy_raytracer_tpu_torch.models.scene import SceneBuilder
from sexy_raytracer_tpu_torch.utils.config import CameraConfig, RenderConfig
from sexy_raytracer_tpu_torch.utils.png import read_png

# the Master Chief mesh's triangle count (2 * 39**2)
CHIEF_TRIANGLES = 3042


def default_data_dir() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.environ.get("SRT_DATA_DIR", os.path.join(repo, "data"))


def _add_ground_and_lights(b: SceneBuilder) -> None:
    """Shared furniture of the flagship scene (reference main.cpp:89-144)."""
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    ground = b.add_pbr_material(albedo_tex=checker)
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground, time0=0.0, time1=1.0)
    light = b.add_light_material(color=(250.2, 220.9, 110.2))
    b.add_sphere((-7.0, 4.0, 6.0), 1.0, light)


def _add_iron_and_metal(b: SceneBuilder, data_dir: str) -> None:
    # rustediron PBR sphere (main.cpp:133-141). The reference asks for
    # "-2x1"-suffixed files that do not exist in its data, so its textures
    # are magenta sentinels — reproduced via read_png -> None.
    iron_albedo = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_basecolor-2x1.png"), 3)
    )
    iron_normal = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_normal-2x1.png"), 3)
    )
    iron_metal = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_metallic-2x1.png"), 1)
    )
    iron_rough = b.add_image_texture(
        read_png(os.path.join(data_dir, "rustediron2_roughness-2x1.png"), 1)
    )
    iron = b.add_pbr_material(
        albedo_tex=iron_albedo,
        normal_tex=iron_normal,
        metallic_tex=iron_metal,
        roughness_tex=iron_rough,
        base_color=(1.0, 1.0, 1.0, 1.0),
    )
    b.add_sphere((-3.0, 1.0, 0.0), 1.0, iron)

    metal = b.add_metal_material((0.7, 0.6, 0.5), 0.0)  # main.cpp:143-144
    b.add_sphere((3.0, 1.0, 0.0), 1.0, metal)


def _flagship_camera() -> CameraConfig:
    # reference main.cpp:163-172
    return CameraConfig(
        eye=(0.0, 3.0, 5.0),
        look_at=(0.0, 2.5, 0.0),
        up=(0.0, 1.0, 0.0),
        vfov_degrees=70.0,
        aperture=0.1,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
    )


def _flagship_config(height: int, spp: int) -> RenderConfig:
    """16:9 at ``height``, 4 bounces, the flagship camera."""
    return RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=_flagship_camera(),
    )


def add_relief_mesh(b, n: int = 39) -> None:
    """Add a procedural relief of ``2 n^2`` triangles in the chief's place.

    The terrain heightfield of ``tools/profile.py`` (an ``n x n`` quad
    grid over [-30, 30]^2, height ``2 sin(0.4x) cos(0.3z) + 0.5 sin(1.7x)``)
    is stood upright, scaled to 3 x 3 units around (0, 2.5, 0), and wound
    so that every face looks towards the flagship eye at (0, 3, 5): the
    find kernels cull back faces. Its PBR material samples an image albedo
    and an image normal map, both made in memory, so the atlas gather and
    normal mapping run. ``b`` is this package's ``SceneBuilder`` or the
    JAX package's: both take the same numpy inputs.
    """
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
        [np.stack([a, a + 1, c], 1), np.stack([a + 1, c + 1, c], 1)]
    )
    # face the eye: flip every triangle whose normal points away from it
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    normal = np.cross(v1 - v0, v2 - v0)
    to_eye = np.array([0.0, 3.0, 5.0]) - (v0 + v1 + v2) / 3.0
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
        base_color=(0.9, 0.8, 0.7, 1.0),
        metallic=0.2,
        roughness=0.5,
    )
    b.add_mesh(verts, uvs, idx, mat)


def flagship_standin(n: int = 39, spp: int = 8, height: int = 720,
                     data_dir: str | None = None, device="cuda",
                     build_bvh: bool = False):
    """The flagship scene with the relief mesh in place of Master Chief.

    Same composition order as ``masterchief`` (reference main.cpp:54-154):
    the mesh, then the ground and light, then the iron and mirror spheres,
    under the flagship camera. ``n = 389`` is the big scene: the
    ``tools/profile.py`` terrain size, 302,642 triangles, past the resident
    find's limit (``ops/intersect.PALLAS_RESIDENT_MAX_TRIS``).

    No BVH by default: this preset has no JAX counterpart, its find
    kernels need none, and with one every train step that moves a sphere
    would refit it (``diff/params.merge_params``).
    """
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    add_relief_mesh(b, n)
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    scene = b.build(build_bvh=build_bvh, device=device)
    return scene, _flagship_config(height, spp)


MASTERCHIEF_ASSET = "masterchief2-separate-xf.gltf"


def flagship_name(data_dir: str | None = None) -> str:
    """``"masterchief"`` when ``data_dir`` (default ``default_data_dir()``)
    holds its asset, else ``"flagship_standin"``."""
    path = os.path.join(data_dir or default_data_dir(), MASTERCHIEF_ASSET)
    return "masterchief" if os.path.exists(path) else "flagship_standin"


def flagship(height: int = 720, spp: int = 1000,
             data_dir: str | None = None, device="cuda"):
    """The flagship scene the tools run on -> ``(scene, config, name)``:
    the preset ``flagship_name`` names, at ``height`` and ``spp``."""
    name = flagship_name(data_dir)
    preset = masterchief if name == "masterchief" else flagship_standin
    return (*preset(data_dir=data_dir, spp=spp, height=height,
                    device=device), name)


def _shirley_config(height: int, spp: int) -> RenderConfig:
    """The book's view of the sphere field: 16:9, 4 bounces, aperture
    0.1 focused at 10 (reference main.cpp:92-122)."""
    return RenderConfig(
        width=int(height * 16 / 9),
        height=height,
        samples_per_pixel=spp,
        max_bounce=4,
        camera=CameraConfig(
            eye=(13.0, 2.0, 3.0),
            look_at=(0.0, 0.0, 0.0),
            vfov_degrees=20.0,
            aperture=0.1,
            focus_dist=10.0,
        ),
    )


def shirley_spheres(seed: int = 4, spp: int = 16, height: int = 240,
                    device="cuda"):
    """The book's random-sphere field (reference main.cpp:92-122).
    Deterministic via a seeded numpy Generator."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))

    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()]
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                # reference ctor pbrMetallicRoughness(color3f) wraps the
                # color in a solidColor albedo map (material.h:25-28)
                mat = b.add_pbr_material(
                    albedo_tex=b.add_solid_texture(albedo)
                )
                center2 = center + np.array([0.0, rng.random() * 0.5, 0.0])
                b.add_sphere(center, 0.2, mat, center1=center2)
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                fuzz = 0.5 * rng.random()
                b.add_sphere(center, 0.2, b.add_metal_material(albedo, fuzz))
            else:
                b.add_sphere(center, 0.2, b.add_dielectric_material(1.5))

    b.add_sphere((0, 1, 0), 1.0, b.add_dielectric_material(1.5))
    b.add_sphere(
        (-4, 1, 0),
        1.0,
        b.add_pbr_material(albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))),
    )
    b.add_sphere((4, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))

    scene = b.build(device=device)
    return scene, _shirley_config(height, spp)


def rustediron_globe(data_dir: str | None = None, spp: int = 64,
                     height: int = 480, device="cuda"):
    """The rusted-iron PBR globe under the flagship furniture."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    return b.build(device=device), _flagship_config(height, spp)


def _branch_transform() -> np.ndarray:
    # reference main.cpp:66-70: translate(0,1,0) * rotY(-15 deg)
    angle = np.deg2rad(-15.0)
    return np.array(
        [
            [np.cos(angle), 0.0, np.sin(angle), 0.0],
            [0.0, 1.0, 0.0, 1.0],
            [-np.sin(angle), 0.0, np.cos(angle), 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def cube(data_dir: str | None = None, spp: int = 64, height: int = 480,
         device="cuda"):
    """cube.gltf under the flagship furniture, lifted onto the ground and
    turned -15 degrees about Y like the reference's square branch
    (main.cpp:66-69)."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    _add_ground_and_lights(b)
    load_gltf(os.path.join(data_dir, "cube.gltf"), b,
              root_transform=_branch_transform())
    return b.build(device=device), _flagship_config(height, spp)


def masterchief(data_dir: str | None = None, spp: int = 1000,
                height: int = 720,
                asset: str = MASTERCHIEF_ASSET,
                root_transform=None, device="cuda"):
    """The reference's randomScene() (main.cpp:54-154): Master Chief mesh +
    checker ground + HDR light + (sentinel-textured) iron PBR sphere +
    mirror metal sphere."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    load_gltf(os.path.join(data_dir, asset), b, root_transform=root_transform)
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    return b.build(device=device), _flagship_config(height, spp)


# halo.glb is the Master Chief mesh of masterchief2-separate-xf.gltf stored
# as GLB with live node transforms; CHIEF_GLB_BAKE is the residual world
# transform (uniform 0.075 scale x rotation) that maps its node-transformed
# triangles onto the -xf geometry (the JAX package's least-squares fit).
CHIEF_GLB_BAKE = np.array(
    [
        [-0.00065918, -0.00265495, -0.0749501, 0.0],
        [0.0, 0.07495299, -0.00265505, 0.0],
        [0.07499711, -0.00002334, -0.00065877, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def masterchief_glb(data_dir: str | None = None, spp: int = 1000,
                    height: int = 720, device="cuda"):
    """The flagship scene loaded through the GLB path (halo.glb)."""
    return masterchief(data_dir=data_dir, spp=spp, height=height,
                       asset="halo.glb", root_transform=CHIEF_GLB_BAKE,
                       device=device)


def square(data_dir: str | None = None, spp: int = 64, height: int = 480,
           device="cuda"):
    """square.gltf branch (main.cpp:60-71): the two-triangle quad under the
    flagship's furniture and camera."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    load_gltf(os.path.join(data_dir, "square.gltf"), b,
              root_transform=_branch_transform())
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    return b.build(device=device), _flagship_config(height, spp)


def scene_gltf(data_dir: str | None = None, spp: int = 64, height: int = 480,
               device="cuda"):
    """scene.gltf branch (main.cpp:77-80): a 15-primitive scene graph with
    node transforms and uint32 indices."""
    data_dir = data_dir or default_data_dir()
    b = SceneBuilder()
    load_gltf(os.path.join(data_dir, "scene.gltf"), b)
    _add_ground_and_lights(b)
    _add_iron_and_metal(b, data_dir)
    return b.build(device=device), _flagship_config(height, spp)


def _lcg_stream(seed: int):
    """The 64-bit LCG of the reference binary ``tests/reforacle``:
    state = state * 6364136223846793005 + 1442695040888963407 mod 2^64, in
    Python ints; value = top 24 bits / 2^24, exact in float32."""
    state = seed & 0xFFFFFFFFFFFFFFFF

    def nxt() -> np.float32:
        nonlocal state
        state = (state * 6364136223846793005 + 1442695040888963407) \
            & 0xFFFFFFFFFFFFFFFF
        return np.float32(state >> 40) / np.float32(16777216.0)

    return nxt


def shirley_parity(seed: int = 42, spp: int = 64, height: int = 240,
                   device="cuda"):
    """The scene the reference binary builds for ``tests/reforacle/reforacle
    W H spp bounces out.png shirley [seed]``: dielectric glass, fuzzy metal,
    moving (motion-blurred) diffuse spheres and thin-lens depth of field
    (reference material.h:87-137, sphere.h:47-52, camera.h:40-50). The
    field restates main.cpp:92-122 with the shared LCG, all arithmetic in
    float32, draw for draw as the C++ makes it."""
    f32 = np.float32
    nxt = _lcg_stream(seed)
    b = SceneBuilder()

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
    b.add_sphere(
        (-4, 1, 0), 1.0,
        b.add_pbr_material(albedo_tex=b.add_solid_texture((0.4, 0.2, 0.1))),
    )
    b.add_sphere((3, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))

    scene = b.build(device=device)
    return scene, _shirley_config(height, spp)


# the JAX package's registry, key for key (flagship_standin is not in it)
PRESETS = {
    "shirley": shirley_spheres,
    "shirley_parity": shirley_parity,
    "cube": cube,
    "rustediron": rustediron_globe,
    "masterchief": masterchief,
    "masterchief_glb": masterchief_glb,
    "square": square,
    "scene": scene_gltf,
}
