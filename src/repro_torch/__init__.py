"""PyTorch and CUDA port of the distributed l-NN system (``src/repro/``).

The same subpackage layout as the JAX package: ``configs``, ``core``,
``kernels``, ``obs``, ``parallel``, ``runtime``, plus ``convert`` for
carrying the reference's point layout across.  The paper's k machines
are a leading tensor dimension on one device.  Nothing here imports
``jax`` or the JAX package.
"""
