"""Softmax training's kernels on the card: ``chip_smoke.py``'s checks of the
window attention backward (``csrc/window_attention_bwd.cu`` through the
autograd Function, against ``window_attention_bwd_plain``, two launches bit
for bit equal) and of the smoke configs' softmax training, card against
CPU.  Marked ``cuda``: they skip without a GPU.  The file imports no JAX,
so it runs on the machine with the card; the CPU tests against the JAX
package are in ``tests/test_torch_softmax_training.py``.
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
@pytest.mark.parametrize("T,W,H,Hkv,d,dv", [
    (200, 48, 4, 1, 128, 128),   # ragged T, W below a tile, Gq 4
    (77, 1, 4, 2, 64, 64),       # the diagonal alone
    (129, 128, 4, 1, 96, 64),    # T = W + 1 over a tile boundary, MLA's widths
    (200, 200, 4, 2, 24, 16),    # W = T (full-causal), MLA's smoke widths
    (200, 128, 8, 2, 128, 128),  # Gq 4 at the zoo's widths, W a multiple of the tile, T ragged
])
def test_window_backward_kernels_on_card(chip_smoke, T, W, H, Hkv, d, dv, dtype):
    chip_smoke.check_window_bwd((2, H, Hkv, T, W, d, dv), dtype, seed=T + W, slice_heads=H)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixtral-8x7b", "minicpm3-4b"])
def test_softmax_smoke_training_on_card_matches_cpu(chip_smoke, name):
    chip_smoke.train_softmax_smoke(name)
