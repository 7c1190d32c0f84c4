"""Live rays over the ray slots of the traced frames' finds at bounce 4
and deeper (the depth every other configuration stops at), counted on
the card by the program's ``live_rays.deep`` counter: the share of the
deep bounces' lanes that still carry a path. A program without that
counter gives nothing to read."""

from benchmark.spans import program_log

COUNTER = "live_rays.deep"


def read(ctx):
    log = program_log()
    if log is None or COUNTER not in log["tallies"]:
        return None
    live, slots = log["tallies"][COUNTER]
    return 100.0 * live / slots if slots else None
