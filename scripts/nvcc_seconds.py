"""Seconds that ``nvcc`` takes to compile each given CUDA source alone, with the
port's build flags (``repro_torch.kernels._build.NVCC_FLAGS``), the sources
in turns for ``--rounds`` rounds: for comparing two versions of one kernel's
build time on one machine.

    mkdir -p build/parent && git archive HEAD~1 src/repro_torch/csrc | tar -x -C build/parent
    python3 scripts/nvcc_seconds.py --rounds 2 build/parent/src/repro_torch/csrc/window_attention.cu \\
        src/repro_torch/csrc/window_attention.cu

Needs ``nvcc``; prints one line per compile and one summary line per source.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.kernels import _build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/nvcc_seconds.py")
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    nvcc = _build.find_nvcc()
    seconds = {src: [] for src in args.sources}
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.rounds):
            order = args.sources if r % 2 == 0 else args.sources[::-1]
            for src in order:
                t0 = time.perf_counter()
                res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", src, "-o",
                                      os.path.join(tmp, "k.o")],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                dt = time.perf_counter() - t0
                if res.returncode:
                    print(res.stdout)
                    print(f"nvcc failed for {src}")
                    return 1
                seconds[src].append(dt)
                print(f"[nvcc] round {r} {src}: {dt:.2f} s", flush=True)
    for src, xs in seconds.items():
        print(f"[nvcc] {src}: {', '.join(f'{x:.2f}' for x in xs)} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
