"""PyTorch + CUDA port of the OMFS reproduction (`repro` is the JAX reference).

Imports torch and numpy only: nothing of jax and nothing of `repro`.
"""
