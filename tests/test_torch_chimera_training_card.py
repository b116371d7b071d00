"""Chimera training's kernels on the card: ``chip_smoke.py``'s checks of the
chimera_attention backward (``csrc/chimera_attention_bwd.cu`` against
``chimera_attention_bwd_plain`` in float64, two launches bit for bit equal)
and of the smoke configs' Chimera training, card against CPU.  "bfloat16" is
the training step's types (all seven inputs bf16): the bf16 route.  Marked
``cuda``: they skip without a GPU.  The file imports no JAX, so it runs on
the machine with the card; the CPU tests against the JAX package are in
``tests/test_torch_chimera_training.py``.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def chip_smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,T,Gq,d,dv,m", [
    (16, 16, 1, 24, 16, 16),      # one chunk: no carried state, MLA's smoke widths
    (32, 64, 2, 16, 16, 16),      # two chunks: the fold without the prefix
    (64, 320, 3, 40, 64, 144),    # five chunks, d % 16 == 8, m off the 64-feature block
    (128, 384, 4, 64, 128, 48),   # a key tile and a query tile apart inside the chunk
    (256, 768, 1, 96, 64, 128),   # MLA's widths at the zoo's chunk
    (256, 512, 4, 128, 128, 128),  # Mixtral's widths at the zoo's chunk
])
def test_chimera_backward_kernels_on_card(chip_smoke, L, T, Gq, d, dv, m, dtype):
    chip_smoke.check_chimera_bwd((2, 2, Gq, T, d, dv, m), L, seed=T + d + m, dtype=dtype,
                                 modes=chip_smoke.CHIMERA_BWD_MODES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixtral-8x7b", "minicpm3-4b"])
def test_chimera_smoke_training_on_card_matches_cpu(chip_smoke, name):
    chip_smoke.train_chimera_smoke(name)
