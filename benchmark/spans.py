"""Readers of the program's own spans and counters
(``sexy_raytracer_tpu_torch/utils/profiling.py``), shared by several
per-layer metrics (``metrics/<name>.py`` imports its ``read`` from here).

The program logs spans and counts while a torch profiler records, and
starts a new log with each recording, so after a traced run its log
holds the traced stretch alone: ``ctx.traced_units`` frames or steps.
A program whose profiling module has no ``snapshot`` (one older than its
spans, as a parent checkout may be) gives nothing to read, and each
reader then returns None. Times in the log are host nanoseconds; a
span's device time is in milliseconds, CUDA event to CUDA event.
"""

from __future__ import annotations

# the names the program gives its spans and counters
WAIT = "wait."
RNG = "rng"
LIVE = "live_rays"


def program_log():
    """The program's snapshot of its log (``spans``: ``[name, parent,
    start ns, end ns, self ns, device ms]``, ``waits``: counts by site,
    ``tallies``: ``[total, slots]`` by name), or None where it has none."""
    from sexy_raytracer_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    log = snapshot()
    return log if log["spans"] else None


def outermost(spans, prefix):
    """The spans whose name starts with ``prefix`` and that lie inside no
    other such span: each stretch counted once."""
    out = []
    for s in spans:
        p, inside = s[1], False
        while p >= 0:
            if spans[p][0].startswith(prefix):
                inside = True
                break
            p = spans[p][1]
        if s[0].startswith(prefix) and not inside and s[3] is not None:
            out.append(s)
    return out


def waits_per_unit(ctx):
    """The host's waits on the device (``wait`` sites entered, each a
    statement that synchronises) in the traced stretch over its frames or
    steps."""
    log = program_log()
    if log is None or not ctx.traced_units:
        return None
    return sum(log["waits"].values()) / ctx.traced_units


def wait_pct(ctx):
    """The host's time at ``wait`` sites (the synchronising statement,
    its own launches and copies included) over the traced stretch's wall
    time, in percent."""
    log = program_log()
    if log is None or not ctx.window_s:
        return None
    ns = sum(s[3] - s[2] for s in outermost(log["spans"], WAIT))
    return 100.0 * ns / 1e9 / ctx.window_s


def rng_device_pct(ctx):
    """The share of the traced stretch's wall time in which an ``rng``
    stretch is open on the device (CUDA event to CUDA event, the idle
    gaps inside included), in percent: an upper bound of the RNG's own
    device time, which the event pairs cannot separate from the gaps."""
    log = program_log()
    if log is None or not ctx.window_s:
        return None
    ms = [s[5] for s in outermost(log["spans"], RNG) if s[5] is not None]
    if not ms:
        return None
    return 100.0 * sum(ms) / 1e3 / ctx.window_s


def live_ray_pct(ctx):
    """Live rays over the ray slots the finds of the traced stretch were
    launched over (every bounce, the visibility pass too), in percent."""
    log = program_log()
    if log is None or LIVE not in log["tallies"]:
        return None
    live, slots = log["tallies"][LIVE]
    return 100.0 * live / slots if slots else None
