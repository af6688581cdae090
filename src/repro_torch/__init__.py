"""AGE-CMPC on PyTorch and CUDA: the port of the ``repro`` package.

The tree mirrors ``src/repro/`` file for file, so each module names the
module it is checked against.  Imports ``torch`` and ``numpy``, never JAX
and nothing of ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; the mod-p products run in hand-written
CUDA kernels (:mod:`repro_torch.kernels`), built with ``nvcc`` on first use.
"""
