"""Hand-written CUDA kernels of the port, one package per TPU kernel.

Each package keeps the reference's name and layout: ``ops.py`` (the
wrapper that launches the kernel on CUDA tensors and counts launches),
``ref.py`` (the plain PyTorch version) and ``csrc/`` (the CUDA sources,
built at first use by :mod:`._build`).
"""
