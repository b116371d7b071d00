"""whisper-tiny training's kernel on the card: ``chip_smoke.py``'s check of
the non-causal backward (``csrc/window_attention_bwd.cu``'s non-causal mode
through the ``_NonCausalAttention`` Function, against
``window_attention_noncausal_bwd_plain`` in float64, two launches bit for
bit equal) and of smoke whisper-tiny's training, card against CPU.  Marked
``cuda``: they skip without a GPU.  The file imports no JAX, so it runs on
the machine with the card; the CPU tests against the JAX package are in
``tests/test_torch_encdec_training.py``.
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
@pytest.mark.parametrize("Tq,Tk,H,Hkv,d,dv", [
    (256, 1536, 6, 6, 64, 64),   # the softmax cross-attention's prefill against the encoder
    (1, 1536, 6, 6, 64, 64),     # a decode tick's query
    (200, 77, 4, 2, 128, 128),   # Tq > Tk, Tk off the key tile, 2 query heads a kv-head
    (77, 200, 4, 1, 96, 64),     # Tq < Tk, 4 query heads a kv-head, MLA's widths
    (129, 1, 6, 3, 24, 16),      # one key
])
def test_noncausal_backward_on_card(chip_smoke, Tq, Tk, H, Hkv, d, dv, dtype):
    chip_smoke.check_noncausal_bwd((2, H, Hkv, Tq, Tk, d, dv), dtype, seed=Tq + Tk)


@pytest.mark.cuda
@pytest.mark.parametrize("use_chimera", [True, False])
def test_whisper_smoke_training_on_card_matches_cpu(chip_smoke, use_chimera):
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels.window_attention import ops as wops

    cfg = dataclasses.replace(smoke_config(chip_smoke.ENCDEC), use_chimera=use_chimera)
    chip_smoke.smoke_card_vs_cpu("train-encdec", "whisper-tiny", cfg,
                                 (wops, "noncausal_bwd_launches"), chip_smoke.ENCDEC_SMOKE_STEPS,
                                 stream=chip_smoke.encdec_smoke_stream(cfg))
