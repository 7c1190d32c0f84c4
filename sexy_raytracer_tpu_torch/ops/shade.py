"""Material tables for shading (counterpart of ``ops/shade.py:104-138``).

Only the packed material rows are ported here: the fused shade kernel
(ops/fused.py) reads them. The unfused ``shade()`` comes with the
reference integrator.
"""

from __future__ import annotations

import torch


def material_packs(scene):
    """Packed material tables: float rows [M,30], int rows [M,9]."""
    mat_f = torch.cat(
        [
            scene.mat_base_color,                # 0:4
            scene.mat_metallic[:, None],         # 4
            scene.mat_roughness[:, None],        # 5
            scene.mat_fuzz[:, None],             # 6
            scene.mat_ior[:, None],              # 7
            scene.mat_albedo_c0,                 # 8:11
            scene.mat_albedo_c1,                 # 11:14
            scene.mat_emit_rgb,                  # 14:17
            scene.mat_emit_c1,                   # 17:20
            scene.mat_metal_cc,                  # 20:22
            scene.mat_rough_cc,                  # 22:24
            scene.mat_normal_c0,                 # 24:27
            scene.mat_normal_c1,                 # 27:30
        ],
        dim=1,
    )
    mat_i = torch.stack(
        [
            scene.mat_type,          # 0
            scene.mat_albedo_kind,   # 1
            scene.mat_normal_kind,   # 2
            scene.mat_metal_kind,    # 3
            scene.mat_rough_kind,    # 4
            scene.mat_pack_layer,    # 5
            scene.mat_pack_w,        # 6
            scene.mat_pack_h,        # 7
            scene.mat_emit_kind,     # 8
        ],
        dim=1,
    )
    return mat_f, mat_i
