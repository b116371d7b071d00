"""Time the kernels of this tree against a tree from before window_attention's
lse output, in turns on one card (``chip_smoke.compare_builds``).

That older ``window_attention_launch`` takes no lse pointer, so its library is
wrapped here: the wrappers' calls reach it with the lse argument, which must be
null (the serving path's forward), dropped.  The reading it gives is the
forward's time with a null lse against the kernel before the output existed.

    git archive <commit before the lse output> src/repro_torch/csrc \\
        | tar -x -C build/pre_lse
    python3 scripts/window_forward_pre_lse.py build/pre_lse/src/repro_torch/csrc

Needs a GPU, ``nvcc`` and both trees' sources; prints ``chip_smoke``'s
``[compare]`` lines.
"""

import ctypes
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


class PreLseWindowLaunch:
    """An older library whose ``window_attention_launch`` has no lse pointer."""

    def __init__(self, lib):
        from repro_torch.kernels import _build

        self._lib = lib
        sig = _build.SIGNATURES["window_attention_launch"]
        fn = lib.window_attention_launch
        fn.argtypes = sig[:4] + sig[5:]  # q, k, v, o, then no lse
        fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def window_attention_launch(self, q, k, v, o, lse, *rest):
        if lse is not None:
            c.fail("the older window_attention_launch writes no lse")
        return self._lib.window_attention_launch(q, k, v, o, *rest)


def main(csrc_dir):
    if "void* lse" in (Path(csrc_dir) / "window_attention.cu").read_text():
        c.fail(f"{csrc_dir}: window_attention_launch already takes lse; use "
               "chip_smoke.compare_builds")
    build_other = c.build_other_library
    c.build_other_library = lambda d: PreLseWindowLaunch(build_other(d))
    c.phase_device()
    c.compare_builds({"pre-lse": csrc_dir})


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
