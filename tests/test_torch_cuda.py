"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where no CUDA device is present. Run them
on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.

The kernels are built without FMA contraction and keep the plain
versions' evaluation order, so the find kernels must return the same prim
ids and t bits; the fused kernels are held to the fused-math tolerance of
tests/test_fused.py (atol 2e-5, rtol 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sexy_raytracer_tpu_torch.models import presets  # noqa: E402
from sexy_raytracer_tpu_torch.models.scene import MAT_LIGHT  # noqa: E402
from sexy_raytracer_tpu_torch.ops import _cuda  # noqa: E402
from sexy_raytracer_tpu_torch.ops import find as tfind  # noqa: E402
from sexy_raytracer_tpu_torch.ops import fused as tfused  # noqa: E402
from sexy_raytracer_tpu_torch.ops.intersect import emissive_sphere_hit  # noqa: E402
from sexy_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    trace_rays_fused,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cuda.build()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev, tmp_path_factory):
    s, _ = presets.flagship_standin(
        n=39, data_dir=str(tmp_path_factory.mktemp("no-assets")))
    return s.to(dev)


def _fuzz(n, dev, seed=42):
    r = np.random.default_rng(seed)
    org = r.normal(0, 3.0, (n, 3)) + np.array([0.0, 2.5, 1.0])
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = r.uniform(0, 1, n)
    t_min = np.where(r.random(n) < 0.1, 3.0e38, 0.001)
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (org, d, t, t_min)]


def test_find_closest_kernel_matches_plain(scene, dev):
    org, d, t, t_min = _fuzz(8192, dev)
    rays, nb = tfind._ray_table(
        [org[:, 0], org[:, 1], org[:, 2], d[:, 0], d[:, 1], d[:, 2], t,
         t_min], {7: 3.0e38})
    sph_bound, _ = tfind._sph_candidates(scene, org, d, t, t_min)
    tri_pack, lists = tfind._scene_lists(scene, org, d, t_min, sph_bound,
                                         nb, cull=True)
    sph_pack = tfind._pack_spheres(scene)
    n = scene.num_triangles
    before = tfind.FIND_CLOSEST.launches
    t_k, p_k = tfind.find_closest(lists, rays, tri_pack, sph_pack, n)
    torch.cuda.synchronize()
    assert tfind.FIND_CLOSEST.launches == before + 1
    t_p, p_p = tfind.find_closest_plain(lists, rays, tri_pack, sph_pack, n)
    assert torch.equal(p_k, p_p)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert ((p_k >= 0) & (p_k < n)).sum() > 100


def test_find_any_kernel_matches_plain(scene, dev):
    """Occlusion as the integrator asks for it: emissive spheres cleared
    from the sphere pack's valid column, bounded by the emissive hit."""
    org, d, t, t_min = _fuzz(8192, dev, seed=7)
    emis = scene.mat_type[scene.sph_mat.long()] == MAT_LIGHT
    assert emis.any() and (~emis).any()
    t_em, _ = emissive_sphere_hit(scene, org, d, t, t_min)
    bound = torch.where(t_min < 1e38,
                        torch.where(torch.isfinite(t_em), t_em, 3.0e38),
                        -3.0e38)
    before = tfind.FIND_ANY.launches
    occ_k = tfind.find_occluded(scene, org, d, t, bound, t_min=t_min,
                                sphere_occluder=~emis)
    torch.cuda.synchronize()
    assert tfind.FIND_ANY.launches == before + 1
    rays, nb = tfind._ray_table(
        [org[:, 0], org[:, 1], org[:, 2], d[:, 0], d[:, 1], d[:, 2], t,
         t_min, bound], {7: 3.0e38, 8: -3.0e38})
    tri_pack, lists = tfind._scene_lists(
        scene, org, d, t_min, torch.clamp(bound, min=0.0), nb, cull=True)
    occ_p = tfind.find_any_plain(lists, rays, tri_pack,
                                 tfind._pack_spheres(scene, ~emis),
                                 scene.num_triangles)[:8192] > 0
    assert torch.equal(occ_k, occ_p)
    # lit lanes stay lit: some rays reach the light unoccluded
    lit = (t_min < 1e38) & torch.isfinite(t_em)
    assert (lit & ~occ_k).sum() > 0


def test_fused_kernels_match_plain(scene, dev, monkeypatch):
    """Every hit-record and shade launch of a 4-bounce trace, against the
    plain math on the same stacks."""
    from sexy_raytracer_tpu_torch.render import integrator

    pairs = []

    def checked(kernel, plain):
        def run(*stacks):
            out = kernel(*stacks)
            pairs.append((out, plain(*stacks)))
            return out
        return run

    monkeypatch.setattr(integrator, "hitrec_fused",
                        checked(tfused.hitrec_fused, tfused.hitrec_math))
    monkeypatch.setattr(integrator, "shade_carry_fused",
                        checked(tfused.shade_carry_fused,
                                tfused.shade_carry_math))
    org, d, t, _ = _fuzz(4096, dev, seed=5)
    keys = torch.stack([torch.arange(4096, device=dev),
                        torch.full((4096,), 3, device=dev)], dim=1)
    trace_rays_fused(scene, org, d, t, keys, torch.ones(3, device=dev), 4,
                     last_bounce_vis=True)
    assert len(pairs) == 8
    for got, want in pairs:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_trace_on_card_matches_cpu(scene, dev):
    org, d, t, _ = _fuzz(4096, dev, seed=3)
    keys = torch.stack([torch.arange(4096, device=dev),
                        torch.full((4096,), 7, device=dev)], dim=1)
    bg = torch.tensor([0.5, 0.7, 0.9])
    rad_k = trace_rays_fused(scene, org, d, t, keys, bg.to(dev), 4,
                             last_bounce_vis=True).cpu().numpy()
    cpu = scene.to("cpu")
    rad_p = trace_rays_fused(cpu, org.cpu(), d.cpu(), t.cpu(), keys.cpu(),
                             bg, 4, last_bounce_vis=True).numpy()
    close = np.isclose(rad_k, rad_p, atol=2e-5, rtol=1e-5).all(axis=1)
    assert close.mean() >= 0.995
