"""Time one Mamba layer's serving forward at Jamba-1.5-Large's width (the
lm-ssm prefill's B 2 x 8,192, bfloat16 input, no gradients) with the port's
token loop, which stacks the steps, against a loop that writes each step
through ``out=`` into a preallocated tensor, in turns (stacked, out=, out=,
stacked) for ``--rounds`` rounds on one card.  The two loops run the same
``addcmul`` in the same order, so their outputs must be bit for bit equal.

    python3 scripts/mamba_loop_turns.py --rounds 2

Needs a GPU; prints one line per timed call and one summary line per loop:
wall milliseconds (the loop is host-bound) and CUDA-event milliseconds.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.layers import promote  # noqa: E402


def ssm_chunk_out(h0, dA, dBx, C):
    """``mamba._ssm_chunk`` with each step written through ``out=``."""
    dt = torch.promote_types(torch.promote_types(dA.dtype, dBx.dtype), h0.dtype)
    dA, dBx = dA.to(dt), dBx.to(dt)
    h = h0.to(dt)
    hs = torch.empty_like(dBx)
    for t in range(dA.shape[1]):
        h = torch.addcmul(dBx[:, t], dA[:, t], h, out=hs[:, t])
    hs_, C = promote(hs, C)
    y = torch.einsum("bcdn,bcn->bcd", hs_, C)
    return y, hs[:, -1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/mamba_loop_turns.py")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=8192)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mamba_loop_turns: needs a GPU", file=sys.stderr)
        return 1
    cfg = get_config("jamba-1.5-large-398b")
    g = torch.Generator().manual_seed(0)
    params = mamba.init_mamba(cfg, g, device="cuda")
    x = torch.randn((args.batch, args.seq, cfg.d_model), generator=g).to("cuda", torch.bfloat16)
    loops = {"stacked": mamba._ssm_chunk, "out=": ssm_chunk_out}

    def run(name):
        mamba._ssm_chunk = loops[name]
        try:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            with torch.no_grad():
                y = mamba.mamba_layer(cfg, params, x)
            end.record()
            torch.cuda.synchronize()
            return y, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)
        finally:
            mamba._ssm_chunk = loops["stacked"]

    want, _, _ = run("stacked")  # warm-up
    got, _, _ = run("out=")
    if not torch.equal(want, got):
        print(f"mamba_loop_turns: the loops differ, max abs "
              f"{float((want.float() - got.float()).abs().max()):.3e}", file=sys.stderr)
        return 1
    del want, got
    times = {name: [] for name in loops}
    for r in range(args.rounds):
        for name in ("stacked", "out=", "out=", "stacked"):
            _, wall, dev = run(name)
            times[name].append((wall, dev))
            print(f"round {r} {name}: wall {wall:.2f} ms, events {dev:.2f} ms", flush=True)
    print(f"{torch.cuda.get_device_name(0)}: mamba_layer at B {args.batch} x {args.seq}, d "
          f"{cfg.d_model}, d_inner {cfg.mamba_expand * cfg.d_model}, d_state "
          f"{cfg.mamba_d_state}, chunk {cfg.mamba_chunk}; outputs bit for bit equal")
    for name, ts in times.items():
        walls, devs = [t[0] for t in ts], [t[1] for t in ts]
        print(f"{name}: wall {min(walls):.2f}-{max(walls):.2f} ms, events "
              f"{min(devs):.2f}-{max(devs):.2f} ms over {len(ts)} calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
