"""Tools of the port: counterparts of the root ``tools/`` scripts
(``profile.py``, ``tputime.py`` as ``devtime``, ``prof_step.py``,
``prof_dump.py``, ``run_inverse_experiment.py``,
``run_flagship_render.py``, ``run_scaling_curve.py``,
``check_find_referee.py``, ``diag_r5.py``) and the kernels' split tools.

Run them as modules, on the card by default (a machine with an NVIDIA
GPU and the CUDA toolkit) or on the CPU with ``--device cpu``::

    python -m sexy_raytracer_tpu_torch.tools.profile histogram
    python -m sexy_raytracer_tpu_torch.tools.prof_step 40
    python -m sexy_raytracer_tpu_torch.tools.prof_dump
    python -m sexy_raytracer_tpu_torch.tools.run_inverse_experiment --phases 1,1b,1c
    python -m sexy_raytracer_tpu_torch.tools.run_flagship_render --spp 1000
    python -m sexy_raytracer_tpu_torch.tools.run_scaling_curve --device cpu
    python -m sexy_raytracer_tpu_torch.tools.check_find_referee
    python -m sexy_raytracer_tpu_torch.tools.diag_r5 --json
"""
