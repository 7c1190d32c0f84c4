"""The benchmark's own tests, on the CPU at toy sizes (card tests skip)."""
