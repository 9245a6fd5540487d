"""PyTorch/CUDA port of the hybrid K(t) parameter-server reproduction.

A second package beside the JAX reference ``repro``: it imports
``torch``, numpy and the standard library, never ``jax`` or ``repro``.
Module names mirror the reference's.  Entry points run on ``cuda``
unless the caller asks for the CPU.
"""
