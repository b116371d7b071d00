"""Training launcher (port of ``repro.launch.train``), on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chimera-dataplane \\
        --steps 100 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

The flags are the JAX launcher's (``--arch``, ``--steps``, ``--batch``,
``--seq``, ``--smoke``, ``--ckpt-dir``, ``--lr``) and ``--device``
(``cuda`` unless ``cpu`` is asked for; without a GPU it raises).  The
default ``--ckpt-dir`` is the port's own, under the temporary directory,
never the JAX launcher's.  The :class:`~repro_torch.train.Trainer` resumes
from the latest checkpoint there, so a second run with the same directory
and ``--steps`` trains no further step.

:func:`build` is the CLI's body up to the trainer, callable in-process;
:func:`main` parses, builds, runs and prints the JAX launcher's rows.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def make_parser() -> argparse.ArgumentParser:
    from repro_torch.train.trainer import TrainerConfig

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="chimera-dataplane")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="use reduced config")
    ap.add_argument("--ckpt-dir", default=TrainerConfig.ckpt_dir)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="where the trainer runs: cuda (default) or cpu")
    return ap


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    return make_parser().parse_args(argv)


def build(args: argparse.Namespace):
    """The :class:`~repro_torch.train.Trainer` the flags describe."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    stream = TokenStream(vocab_size=arch.vocab_size, batch_size=args.batch,
                         seq_len=args.seq + 1)
    return Trainer(
        arch,
        TrainerConfig(
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            log_every=max(1, args.steps // 20),
            ckpt_every=max(10, args.steps // 4),
        ),
        stream,
        opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
        device=args.device,
    )


def main(argv: Optional[List[str]] = None) -> dict:
    trainer = build(parse_args(argv))
    out = trainer.run()
    for row in out["log"]:
        print(
            f"step {row['step']:5d} loss {row.get('loss', float('nan')):.4f} "
            f"({row['step_seconds']*1e3:.0f} ms/step)"
        )
    return out


if __name__ == "__main__":
    main()
