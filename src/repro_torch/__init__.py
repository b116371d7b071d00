"""Chimera on PyTorch and CUDA: the port of :mod:`repro` for one NVIDIA H100.

The package mirrors the JAX package's module names (``core``, ``models``,
``train``, ``data``, ``serve``, ``kernels``) so a reader can find each
counterpart.  It imports ``torch`` and numpy only — never ``jax`` and
nothing of ``repro`` — and keeps its own copy of what it needs.

Everything runs in float32, as the paper's configuration does; TF32 is
switched off explicitly for matrix products and convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
