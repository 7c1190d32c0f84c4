"""The host's waits on the card in the traced frames, a frame: the
program's ``wait`` sites entered (uploads from pageable memory, reads
back; each a statement that synchronises on the frame's scene), counted
by the program: an exact count."""

from benchmark.spans import waits_per_unit as read  # noqa: F401
