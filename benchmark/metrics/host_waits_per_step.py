"""The host's waits on the card in the traced steps, a step: the
program's ``wait`` sites entered (uploads from pageable memory, reads
back; each a statement that synchronises), counted by the program: an
exact count."""

from benchmark.spans import waits_per_unit as read  # noqa: F401
