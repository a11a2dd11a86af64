"""PyTorch/CUDA port of ``nobs_whisper_tpu`` for one NVIDIA H100.

Mirrors the JAX package's file layout: each module's reference is the file
at the same relative path under ``nobs_whisper_tpu/``. The port imports
neither JAX nor the JAX package; the two Pallas kernels of the serving
path are hand-written CUDA under ``csrc/``.
"""
