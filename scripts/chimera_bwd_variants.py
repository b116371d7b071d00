"""Time this tree's Chimera attention backward (``csrc/chimera_attention_bwd.cu``)
against a variant of its source, in turns on one card, at the train-chimera
phase's two training shapes (Mixtral-8x7B's Chimera, MiniCPM3-4B's Chimera
MLA; ``chip_smoke.chimera_bwd_shapes``): this, other, other, this, this,
other, five calls timed by CUDA events each, and the largest difference of
the two versions' gradients relative to each gradient's largest entry.  Then
``chip_smoke``'s own checks of this tree's backward (the Function's
gradients, both training shapes timed, the edge shapes).

    mkdir -p build/variant
    cp src/repro_torch/csrc/chimera_attention_bwd.cu src/repro_torch/csrc/split_fp32.cuh build/variant/
    # edit build/variant/chimera_attention_bwd.cu, then
    PYTHONPATH=. python3 scripts/chimera_bwd_variants.py build/variant

The variant directory needs only ``chimera_attention_bwd.cu`` and the
headers it includes (``chip_smoke.build_other_library`` builds what it
holds).  Needs a GPU and ``nvcc``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def main(variant_dir):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.chimera_attention import ops

    c.phase_device()
    c.phase_build()
    libs = {"this": _build.load_library(), "other": c.build_other_library(variant_dir)}
    for shape in c.chimera_bwd_shapes():
        B, Hkv, Gq, T, d, dv, m = shape
        xs = c.chimera_bwd_inputs(B, Hkv, Gq, T, d, dv, m, c.SEED + 110)
        flat = [x.flatten(0, 1).contiguous() for x in xs]
        outs, times = {}, {k: [] for k in libs}
        try:
            for ver in ("this", "other", "other", "this", "this", "other"):
                _build._lib = libs[ver]
                with torch.no_grad():
                    outs[ver] = ops.chimera_attention_bwd_bh(*flat, chunk_size=c.ZOO_L)
                    times[ver].append(c.event_ms(lambda: ops.chimera_attention_bwd_bh(
                        *flat, chunk_size=c.ZOO_L), iters=5))
        finally:
            _build._lib = libs["this"]
        diff = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(outs["other"], outs["this"]))
        c.log("variants", f"chimera_attention backward at {shape}: ms "
                          + "; ".join(f"{ver} {', '.join(f'{t:.4f}' for t in ts)}"
                                      for ver, ts in times.items())
                          + f"; largest difference {diff:.3e} of a gradient's largest entry")
        del xs, flat, outs
        torch.cuda.empty_cache()
    c.check_chimera_grads()
    c.check_chimera_bwd_kernels({})


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
