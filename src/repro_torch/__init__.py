"""Chimera on PyTorch and CUDA: the port of :mod:`repro` for one NVIDIA H100.

The package mirrors the JAX package's module names (``core``, ``models``,
``train``, ``data``, ``serve``, ``kernels``) so a reader can find each
counterpart.  It imports ``torch`` and numpy only — never ``jax`` and
nothing of ``repro`` — and keeps its own copy of what it needs.

Parameters are float32, as the JAX package draws them; the residual
stream runs in ``ArchConfig.dtype`` (float32 in the paper's configuration,
bfloat16 by default), and products of bfloat16 activations with float32
weights are float32, as jnp's type promotion makes them.  TF32 is switched
off explicitly for matrix products and convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device, who: str) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``, and a
    CUDA request without a GPU raises (there is no silent CPU fallback)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    return device
