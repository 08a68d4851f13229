"""Frozen copies of what the benchmark measures with (see each module)."""
