"""PyTorch and CUDA port of ``yamimageprocessor_tpu`` for NVIDIA Hopper.

The JAX package stays the reference.  This package imports nothing of it:
it keeps its own copies of the host code it needs (op records, parameter
splits, tap and table constructors, pipeline steps) and ports what runs on
the device: the op registry, the chain runner, the pipeline manager and
the ops of the flagship preprocess chain and of the segmentation chain,
with hand-written CUDA kernels for sm_90a in ``csrc/`` (built by
:mod:`._build`).  It never imports jax.
"""
