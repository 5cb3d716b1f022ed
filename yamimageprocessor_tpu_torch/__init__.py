"""PyTorch and CUDA port of ``yamimageprocessor_tpu`` for NVIDIA Hopper.

The JAX package stays the reference.  This package reuses its host code
(op schemas, parameter splits, numpy golden functions, pipeline steps and
manager) and ports what runs on the device: the op registry, the chain
runner and the ops of the flagship preprocess chain, with hand-written
CUDA kernels for sm_90a in ``csrc/`` (built by :mod:`._build`).  It never
imports jax.
"""
