"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each family lives in ``<family>/ops.py``: a wrapper that launches the CUDA
kernel for CUDA tensors (built from ``repro_torch/csrc`` by :mod:`._build`)
and runs the plain version for CPU tensors, plus a launch counter.  The
JAX package's ``kernels/dispatch.py`` backend registry is not ported: the
device of the tensors decides between kernel and plain version.
"""
