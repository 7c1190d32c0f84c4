"""Trainable-parameter partitioning for inverse rendering (counterpart of
``sexy_raytracer_tpu/diff/params.py``).

Parameters are a plain dict of scene-field name -> tensor; ``merge_params``
rebuilds a consistent scene from them, re-deriving what trained geometry
invalidates.
"""

from __future__ import annotations

import torch

from sexy_raytracer_tpu_torch.models.bvh import refit_bvh_device
from sexy_raytracer_tpu_torch.models.clusters import cluster_bounds_device
from sexy_raytracer_tpu_torch.models.scene import SceneData, prepare_triangles

# shade_atlas = the baked 8-channel map pack (the texture recovery target);
# material factors; checker/solid albedo colours; sphere centres (moving
# spheres train both endpoints). Triangle vertices ("tri_v0"...) may be
# added for geometry optimisation.
DEFAULT_TRAINABLE = (
    "shade_atlas",
    "mat_base_color",
    "mat_metallic",
    "mat_roughness",
    "mat_albedo_c0",
    "mat_albedo_c1",
    "sph_c0",
    "sph_c1",
)

_GEOMETRY_FIELDS = {"tri_v0", "tri_v1", "tri_v2"}
_SPHERE_GEOMETRY_FIELDS = {"sph_c0", "sph_c1", "sph_radius", "sph_t0",
                           "sph_t1"}


def extract_params(scene: SceneData, names=DEFAULT_TRAINABLE) -> dict:
    return {name: getattr(scene, name) for name in names}


def merge_params(scene: SceneData, params: dict) -> SceneData:
    """Rebuild a consistent scene from updated parameter tensors.

    Trained triangle vertices re-derive the triangle plane/edge pack and
    the cluster cull boxes; trained triangles or spheres refit the BVH
    bounds of a scene that carries one. All of these feed only hit search,
    which is stop-gradient, so they are derived detached.
    """
    scene = scene._replace(**params)
    tri_geom = bool(_GEOMETRY_FIELDS & set(params))
    sph_geom = bool(_SPHERE_GEOMETRY_FIELDS & set(params))
    if tri_geom:
        with torch.no_grad():
            tri_n, tri_d, tri_q, tri_c = prepare_triangles(
                scene.tri_v0, scene.tri_v1, scene.tri_v2)
            scene = scene._replace(tri_n=tri_n, tri_d=tri_d, tri_q=tri_q,
                                   tri_c=tri_c)
            if scene.cluster_min.shape[0] > 0:
                cmin, cmax = cluster_bounds_device(
                    scene.tri_v0, scene.tri_v1, scene.tri_v2)
                scene = scene._replace(cluster_min=cmin, cluster_max=cmax)
    if (tri_geom or sph_geom) and scene.bvh_min.shape[0] > 0:
        bmin, bmax = refit_bvh_device(scene)
        scene = scene._replace(bvh_min=bmin, bvh_max=bmax)
    return scene
