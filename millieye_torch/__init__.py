"""PyTorch + CUDA port of the milliEye radar+camera fusion detector.

``millieye_tpu`` (JAX/Pallas on a TPU) is the reference and stays as it
is; this package mirrors its file names so each counterpart is easy to
find. It imports ``torch`` and numpy only. The Pallas kernels of the
serving path are hand-written CUDA C++ for Hopper under ``csrc/``, built
with ``nvcc`` at first use (``ops/cuda_lib.py``); each has a plain
PyTorch version beside its wrapper, which a CPU tensor takes.
"""
