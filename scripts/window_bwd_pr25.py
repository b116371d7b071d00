"""Time this tree's window attention backward against the first design's
(fp32 FMAs on the CUDA cores for bf16 inputs too), in turns on one card
(``chip_smoke.compare_builds``).

The first design's library has the same C entry points as this tree's, so
its ``window_attention_bwd_launch`` is reached as it stands; the script only
checks that the tree given is that design, builds it beside this tree's and
times the backward at the train-softmax phase's two bf16 training shapes
(Mixtral-8x7B's SWA, MiniCPM3-4B's W = T), on o and lse from this tree's
forward: this, other, other, this.

    mkdir -p build/bwd_cuda_cores
    git archive a68ff6f src/repro_torch/csrc | tar -x -C build/bwd_cuda_cores
    python3 scripts/window_bwd_pr25.py build/bwd_cuda_cores/src/repro_torch/csrc

Needs a GPU, ``nvcc`` and both trees' sources; prints ``chip_smoke``'s
``[compare]`` lines.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def main(csrc_dir):
    src = (Path(csrc_dir) / "window_attention_bwd.cu").read_text()
    if "mma.sync.aligned" in src:
        c.fail(f"{csrc_dir}: its backward already runs on the tensor cores; use "
               "chip_smoke.compare_builds")
    c.phase_device()
    c.compare_builds({"cuda-cores": csrc_dir}, only=("window_attention_bwd",))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
