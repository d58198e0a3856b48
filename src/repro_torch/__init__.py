"""PyTorch/CUDA port of the ``repro`` package (Unbiased Gradient Low-Rank
Projection), for NVIDIA Hopper GPUs.

The JAX package ``repro`` beside it is the frozen reference; this package
imports nothing from it and no JAX.  Subpackages mirror ``repro``'s names
(``configs``, ``data``, ``kernels``, ``core``, ``models``, ``launch``,
``train``, ``serve``, ``checkpoint``, ``resilience``, ``telemetry``) so
each module's counterpart is easy to find.  The entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
