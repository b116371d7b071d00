"""Time this tree's Chimera attention backward (``csrc/chimera_attention_bwd.cu``)
against another build of it, in turns on one card, at the train-chimera
phase's two training shapes (Mixtral-8x7B's Chimera, MiniCPM3-4B's Chimera
MLA; ``chip_smoke.chimera_bwd_shapes``) in the training step's types (all
seven inputs bf16): this, other, other, this, this, other, five calls timed
by CUDA events each, twice:

* kernels: each build's route for these types as the wrapper takes it.  A
  build without the bf16 route (``chimera_attention_bwd_bf16_launch``; the
  first tensor-core design) is given all seven inputs widened to fp32
  beforehand, so that its kernels alone are timed;
* step: the wrapper call as the training step pays it, casts included: the
  widening of the inputs inside the call for a build without the bf16
  route, and on both the cast of dq, dk and dv back to bf16 that
  ``_Partials.backward`` makes.

Then the largest difference of the two builds' gradients relative to each
gradient's largest entry, and ``chip_smoke``'s own checks of this tree's
backward (the Function's gradients, both training shapes timed, the edge
shapes).

    mkdir -p build/variant
    git show 2a8dc74:src/repro_torch/csrc/chimera_attention_bwd.cu > build/variant/chimera_attention_bwd.cu
    cp src/repro_torch/csrc/split_fp32.cuh build/variant/
    PYTHONPATH=. python3 scripts/chimera_bwd_variants.py build/variant

The directory needs only ``chimera_attention_bwd.cu`` and the headers it
includes (``chip_smoke.build_other_library`` builds what it holds; a
variant of this tree's source also needs ``hopper.cuh``).  Needs a GPU and
``nvcc``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402

ORDER = ("this", "other", "other", "this", "this", "other")


def main(variant_dir):
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.chimera_attention import ops

    c.phase_device()
    c.phase_build()
    libs = {"this": _build.load_library(), "other": c.build_other_library(variant_dir)}
    bf16 = {ver: hasattr(lib, "chimera_attention_bwd_bf16_launch") for ver, lib in libs.items()}
    dtype = "bfloat16"  # the training step's types
    for shape in c.chimera_bwd_shapes():
        B, Hkv, Gq, T, d, dv, m = shape
        ins = [x.flatten(0, 1).contiguous()
               for x in c.chimera_bwd_inputs(B, Hkv, Gq, T, d, dv, m, c.SEED + 110, dtype)]
        wide = [x.float() for x in ins]

        def kernels(ver):
            return ops.chimera_attention_bwd_bh(*(ins if bf16[ver] else wide), chunk_size=c.ZOO_L)

        def step(ver):
            xs = ins if bf16[ver] else [x.float() for x in ins]
            got = ops.chimera_attention_bwd_bh(*xs, chunk_size=c.ZOO_L)
            return [g.to(x.dtype) for g, x in zip(got, ins[:5])]

        outs, times = {}, {(what, ver): [] for what in ("kernels", "step") for ver in libs}
        try:
            for what, fn in (("kernels", kernels), ("step", step)):
                for ver in ORDER:
                    _build._lib = libs[ver]
                    with torch.no_grad():
                        if what == "kernels":
                            outs[ver] = fn(ver)
                        times[what, ver].append(c.event_ms(lambda: fn(ver), iters=5))
        finally:
            _build._lib = libs["this"]
        diff = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(outs["other"], outs["this"]))
        c.log("variants", f"chimera_attention backward at {shape}, {dtype}: ms "
                          + "; ".join(f"{what} {ver} ({'bf16' if bf16[ver] else 'fp32'} route) "
                                      f"{', '.join(f'{t:.4f}' for t in ts)}"
                                      for (what, ver), ts in times.items())
                          + f"; largest difference {diff:.3e} of a gradient's largest entry")
        del ins, wide, outs
        torch.cuda.empty_cache()
    c.check_chimera_grads()
    c.check_chimera_bwd_kernels({})


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
