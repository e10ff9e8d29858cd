"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on the H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Nothing here imports
``jax`` or the JAX package ``repro``.
"""
