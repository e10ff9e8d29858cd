"""Plain NumPy/PyTorch reference of what the timed path computes.

Imports neither ``jax``, nor ``repro``, nor anything of ``repro_torch``:
it reads the benchmark's own weights and queries (attributes of the query
objects only) and works the program's derived values out again.
"""
