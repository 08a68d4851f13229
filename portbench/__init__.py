"""The port's benchmark (see portbench/run.py)."""
