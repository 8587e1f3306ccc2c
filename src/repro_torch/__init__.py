"""PyTorch + CUDA port of ``repro`` (W4A4 MSFP diffusion serving).

Sub-packages mirror ``src/repro/`` module for module. The port imports
``torch``, ``numpy`` and the standard library only; the kernels that the
JAX package wrote in Pallas for the TPU are CUDA C++ for ``sm_90a`` under
``kernels/csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).
"""
