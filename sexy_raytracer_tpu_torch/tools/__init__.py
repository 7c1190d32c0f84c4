"""Profiling tools of the port (counterparts of the root ``tools/`` scripts
``profile.py``, ``tputime.py``, ``prof_step.py`` and ``prof_dump.py``).

Run them as modules, on the card by default or on the CPU with
``--device cpu``::

    python -m sexy_raytracer_tpu_torch.tools.profile histogram
    python -m sexy_raytracer_tpu_torch.tools.prof_step 40
    python -m sexy_raytracer_tpu_torch.tools.prof_dump
"""
