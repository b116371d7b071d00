#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device    — requires CUDA; prints the card's name and power limit.
2. build     — builds the port's CUDA kernels from ``src/repro_torch/csrc``
               and prints each kernel's registers, static shared memory and
               spills as ``nvcc -Xptxas -v`` reports them.
3. kernels   — holds each kernel against its plain PyTorch version on the
               card at its main path's shapes (decode_step under three fill
               patterns: no flow folding, the spread the kernels line
               reports, every flow folding) and at the edge shapes of its
               contract, and times both; checks the gradients of the
               chimera_attention Function (its forward and backward kernels);
               window_attention's non-causal mode at whisper-tiny's encoder
               shape (B 8 x H 6, T 1,536, d 64; fp32 and bf16, timed beside
               scaled_dot_product_attention) and at its edges (Tq != Tk, Tk
               off the key tile, Tq = 1), and a call with a gradient at one
               segment of that shape (the non-causal backward, fp32 and
               bf16).
4. engine    — the serving path: a ``FlowEngine`` at the paper's full width
               (chimera-dataplane: d 256, m 256, L 64, n_global 64; FLOW_LAYERS
               1 of its 4 layers; capacity 4096, lanes 256) with random
               weights from a seed ingests protocol-mix and rule-violating
               batches.
5. train     — the classifier objective at the same width
               (``train_classifier``, batch 256 x 256 tokens), then one
               profiled classifier step (forward against backward).
6. serve     — the LM serving path: ``ServeEngine`` on Mixtral-8x7B's
               softmax variant (sliding-window attention, MoE) at full width,
               2 of its 32 layers, random weights from a seed: a prefill of
               4 x 8192 tokens through the window_attention kernel, then 16
               new tokens per slot over the ring KV cache; one profiled
               prefill.
7. reference — the engine on a small table (REFERENCE_LAYERS 2 of the
               paper model's 4 layers), 3 classifier training steps of
               a small model, and serving of a small softmax-SWA MoE model,
               on the card and on the CPU (plain versions): they must agree.
8. program   — run right after the engine phase: the int_flow_score kernel
               against its plain version bit for bit at the engine's shapes
               (M 1 and 300, timed) and at its edge shapes on adversarial
               inputs (and flow_score at 24 signature words), then the compiled
               DataplaneProgram: the paper's classifier (FLOW_LAYERS 1 of its
               4 layers) compiled, saved,
               loaded and deployed per-round and fused, with two table
               swaps between batches, fused held to per-round after each;
               then int-emulation engines at the smoke width on the card
               beside the CPU, with a swap mid-stream.

9. adapt     — run after the program phase: (a) the port's launcher
               (``repro_torch.launch.flow_serve``'s build and serve) at the
               paper's width (FLOW_LAYERS 1 of its 4 layers), fused, on the default drift schedule with no
               loop, under the sync and the async adaptation loop and with
               no loop again: packets/s, drift-path ms per tick, epoch ms,
               install µs, triggers, veto rate by phase; S pinned, no flip,
               no eviction, no capture after warm-up.  (b) The CPU tests'
               canonical drift replay at the tiny width, fused on the card
               against per-round on the CPU, float and int-emulation, and an
               async epoch held inside a fresh CUDA-graph capture.  (c) The
               red-team gate (smoke campaign + sample trace) on the card and
               on the CPU with the port's own weights.

10. shard    — run after the adapt phase: sharded and elastic flow serving,
               all shards on the one card.  decode_step at the stacked width
               (4 shards x 256 lanes) against its plain version, timed;
               (a) a ShardedFlowEngine of 4 shards x 1024 slots beside a
               FlowEngine of 4096 at the paper's width (SHARD_LAYERS 1 of its 4 layers)
               on the same batches: decisions identical, packets/s of both,
               busy share, launches
               per round; (b) the elastic service through the launcher
               (reshard 2 -> 4 -> 2, checkpoints to a temporary directory),
               then a shard killed and recovered, held to a service never
               killed; (c) sharded int-emulation at the smoke width, card
               against CPU.

11. lm-chimera — run after the serve phase: Chimera prefill and LM serving
               at the model zoo's default Chimera widths (L 256, d = dv = m
               128).  (a) decode_step (tiled ring) at Gq 1, 4 and 8 under
               four fill patterns and chimera_attention
               (``csrc/chimera_attention_long.cu``) at the prefill shape and
               its edges, against their plain versions, timed; (b) the port's
               LM launcher (``repro_torch.launch.serve``'s build and serve) on
               Mixtral-8x7B's Chimera variant, Moonshot-v1-16B-A3B and
               Chameleon-34B, each at full width, 2 layers: prefill_batch of
               4 x 8192 tokens, 16 new tokens per slot; (c) that prefill and
               decode against the plain versions on the card, and a ragged
               641-token prompt's prefill_batch against token-by-token
               decode; (d) seven configs' smoke sizes through prefill_batch
               and decode, card against CPU, and the baseline chunked linear
               attention card against CPU; (d) also MiniCPM3-4B's smoke
               config, and its and Yi-9B's full-causal softmax variants.

12. trainer  — run after the lm-chimera phase: the ``Trainer`` on the card.
               chimera_attention at lm_100m's shape (L 128, m 64, BH 96)
               against its plain version, timed, with its gradients; (a)
               ``launch/train.py`` at its defaults (chimera-dataplane, batch
               8 x 128, 100 steps): ms/step, tokens/s, checkpoint save and
               restore, peak memory; its smoke config card against CPU; (b)
               10 steps direct against 5 + 5 through a checkpoint, in
               deterministic mode; (c) the codebook map (m 256, 256
               centroids) with the two-timescale controller (installs every
               10 steps) against the same run without it (its k-means on
               the card timed apart), the same controller run on the card
               (deterministic mode, recorded) held to the CPU by two checks:
               every code, signature bit and k-means recomputed on the CPU
               from the card's inputs, and the losses, installs and
               centroids of a CPU run fed the card's codes, signature bits
               and farthest-point picks; an 8-bit codebook program compiled
               by the port, saved, loaded and deployed on the card and on
               the CPU; (d) examples/train_lm.py's
               lm_100m through the Trainer (1 + 20 steps) and one profiled step.

13. lm-mla   — run after the lm-chimera phase: MiniCPM3-4B's multi-head
               latent attention and full-causal softmax attention.  (a)
               decode_step and chimera_attention_long.cu at MLA's widths (4
               slots x 40 heads, Gq 1, d 96, dv 64, m 128, L 256; T 8192),
               both at MLA's smoke widths, and window_attention at W = T =
               8192 for MiniCPM3-4B's and Yi-9B's softmax variants, against
               their plain versions, timed; (b) MiniCPM3-4B through the LM
               launcher at full width, 2 of 62 layers with phase 11's (c)
               checks, then 4 layers (MLA_DEPTH), timed (prefill tokens/s, ms per
               tick, busy share, peak memory); (c) the softmax variants of
               MiniCPM3-4B (MLA latent cache) and Yi-9B (GQA, Gq 8) at full
               width, 2 layers, T 8192: against the plain version on the card
               (also with float32 activations on both routes, where no bf16
               rounding of the residual stream stands between them) and a
               ragged 641-token prompt against token-by-token decode.

14. train-softmax — run after the lm-mla phase, before the trainer phase:
               softmax attention trained on the card.  (a) the window
               kernels' backward (csrc/window_attention_bwd.cu, three
               launches) against window_attention_bwd_plain at Mixtral-8x7B's
               training shape (B 1 x H 32 over 8, T 8192, W 4096, d = dv =
               128) and MiniCPM3-4B's W = T = 8192 (H = Hkv 40, d 96, dv 64),
               bf16 (the tensor-core route) and fp32, and at every edge
               shape at every (d, dv) of the contract; two launches bit for
               bit equal; timed with the forward (against its own bound),
               forward + backward, the three kernels' split from a profiler
               trace, and scaled_dot_product_attention's backward alone and
               forward + backward; (b) Mixtral-8x7B's softmax SWA
               variant and (c) MiniCPM3-4B's full-causal variant through the
               Trainer at full width, 2 layers, B 1 x 8192, remat "full": 1 +
               5 AdamW steps (ms/step, tokens/s, peak memory), one profiled
               step, and the whole step's loss and gradients against the
               plain route on the card (fp32, seq 2048); (d) both smoke
               configs' softmax variants, 10 Trainer steps, card against CPU.

15. train-chimera — run after the train-softmax phase, before the trainer
               phase: Chimera attention trained on the card.  (a) the
               backward kernels (csrc/chimera_attention_bwd.cu: the bf16
               route's split, fold, prefix, stream, dK/dV and dQ on wgmma;
               the fp32 route's fold, prefix, dK/dV and dQ) against
               chimera_attention_bwd_plain in float64 at Mixtral-8x7B's
               Chimera training shape (B 1 x Hkv 8, Gq 4, T 8192, d = dv = m
               128, L 256) and MiniCPM3-4B's MLA Chimera shape (H = Hkv 40, d
               96, dv 64), in the training step's types (all seven bf16: the
               bf16 route) and from fp32 inputs (the fp32 route), each
               timed, and at every chunk of the contract x T in {L, 3L} x
               three flag pairs x eight (d, dv, m) in each of the two;
               two launches bit for bit equal; timed beside the forward,
               with the kernels' split from a profiler trace; (b)
               Mixtral-8x7B's Chimera variant and (c) MiniCPM3-4B's Chimera
               MLA variant through the Trainer at full width, 2 layers, B 1
               x 8192, remat "full": 1 + 5 AdamW steps on the bf16 route
               (the types reaching the backward logged), one profiled step,
               the whole step against the plain route on the card (fp32,
               seq 2048, the fp32 route); (d) both smoke configs' Chimera
               variants, 10 Trainer steps, card against CPU.  The train and
               trainer phases' Chimera training runs the backward kernels
               too.

16. lm-ssm   — run after the train-ssm phase, before the trainer
               phase: Mamba and xLSTM served on the card.  (a) decode_step
               and chimera_attention_long.cu at Jamba's attention widths (2
               slots x 8 kv-heads, Gq 8, d = dv = m 128, L 256; T 8192)
               against their plain versions, timed;
               (b) Jamba-1.5-Large at full width, 2 of its 72 layers (a
               Mamba block with the MoE of 16 experts and a Chimera
               attention block with the dense MLP), through the LM
               launcher: 2 x 8,193-token prompts and 16 new tokens each,
               prefill tokens/s, ms per tick, peak memory, a profiled
               prefill's device time by kernel and by scan; its generations
               held to the plain route on the card, and a ragged 257-token
               prefill against token-by-token decode; (c) xLSTM-125M at
               full depth and width the same way (4 x 2,050-token prompts);
               (d) both smoke configs card against CPU.

17. lm-encdec — run after the lm-ssm phase, before the trainer phase:
               whisper-tiny's encoder-decoder served on the card at full
               width and depth (4 + 4 layers, d 384, bf16, random weights):
               decode_step and chimera_attention_long.cu at its decoder's
               widths against their plain versions, timed; B 8 segments x
               Te 1,536 frames through encode (the non-causal mode of
               window_attention in every encoder layer), the teacher-forced
               forward at T 256 and 448 decode_step ticks (256 forced, 192
               greedy); (a) the kernel route against the plain route on the
               card (encoder output, logits, greedy tokens), (b) decode
               against the teacher-forced forward, (c) both again for the
               softmax cross-attention variant at 1 decoder layer, (d) encode,
               forward and per-tick ms, peak memory, launches.  The smoke
               phase adds smoke whisper-tiny, card against CPU.

18. train-encdec — run after the train-chimera phase: whisper-tiny trained
               on the card.  (a) window_attention_bwd.cu's non-causal mode
               against window_attention_noncausal_bwd_plain in float64 at the
               encoder's training shape (B 8 x H 6, Tq = Tk 2,048, d = dv =
               64), bf16 and fp32, each timed beside its bound and
               scaled_dot_product_attention's backward, and at the forward's
               edge shapes x six (d, dv) x fp32 and bf16; the Chimera
               backward timed at the decoder's training shape (BH 48, T
               2,048, the bf16 route); (b) whisper-tiny at
               full width and depth through the Trainer on its train cell (B
               8 x (Te 2,048 frames + T_dec 2,048 tokens), bf16, remat
               "full"): 1 + 5 AdamW steps, ms/step, positions/s, peak memory,
               busy share, launches, the types reaching the non-causal
               backward; (c) the whole step against the plain route on the
               card in fp32; (d) (b) and (c) for the softmax cross-attention
               variant at 1 decoder layer; (e) smoke whisper-tiny (both
               branches) through the Trainer, card against CPU.

19. train-ssm — run after the train-encdec phase: Jamba-1.5-Large's
               training cut (full width, a Mamba and a Chimera attention
               block with dense MLPs) at B 1 x 4,096 (1 + 2 steps) and
               xLSTM-125M at full depth at B 4 x 512 (1 + 1) through the
               Trainer (ms/step, tokens/s, peak memory; busy share and the
               "mamba", "mlstm" and "slstm" scopes of a step profiled at T
               512 and 16), Jamba's whole step against the plain route in
               fp32 at 2,048, both smoke configs card against CPU.

20. verify   — run right after the program phase: the compiler's static
               verification (pass 6), the graph-capture sentry and the
               quantized state cache.  The paper's classifier (FLOW_LAYERS 1
               of its 4 layers) compiled on the card with verification on
               the float backend and on int-emulation (every
               static-verification row logged; the int program's Thm A.3
               divergence is over budget at this width, waived at compile,
               and its deploy must be refused); the float program deployed
               fused (capacity 4096, lanes 256) and the smoke-width
               int-emulation program likewise, each warmed and then fed
               protocol-mix and rule-violating batches under
               ``RetraceSentry.expect_no_retrace`` (no capture after
               warm-up); the elastic reshard cycle 1 -> 2 -> 1 at the paper's
               width under the sentry; ``quant_decode_step`` at the engine's
               capacity (B 4096 x Hkv 4, m 256, d = dv 64, L 64, n_global
               64) for 8 ticks through decode_step.cu, each tick held against
               the plain version on the card from the same quantized state
               (requantized ints one step apart at most, the share logged),
               against an unquantized run, with state_bytes and the step's
               device time beside the unquantized step's; the analysis
               gate's two canaries.

Phases 4, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19 and 20 are
the main paths: the kernels' launch counters are zeroed just before each
(each part of phases 10, 12, 13, 14, 15, 16, 17, 18 and 19) and read just
after, and each fails if one of its kernels never launched.  Then
a JSON line with every kernel's numbers, a JSON line ``{"phases": {...}}``
with every phase's seconds (and the run's total), and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero
without it.  It imports nothing of JAX and nothing of the JAX package.

``compare_builds({label: dir})`` times every kernel at its main path's
shape from this tree against the same kernels built from other trees'
``csrc`` directories, in turns on one card (this, other, other, this).
``route_gaps(n_seeds, {label: dir}, name=...)`` gives the readings behind
ROUTE_MARGIN: the top-k gaps of a MoE config's choices
that differ between a ragged prefill and token-by-token decode, with each
tree's kernels, the plain versions and a planted attention error;
``route_flip_cause(i, name)`` which kernel and tier one seed's flips come
from.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores (decode_step, flow_score)
TF32_FLOPS = 495e12  # TF32 on the tensor cores (chimera_attention, window_attention)
BF16_FLOPS = 989e12  # bf16 on the tensor cores, fp32 accumulation (bf16 window backward)
# chimera_attention and window_attention run each fp32 product as three
# TF32 products (split fp32)
TF32_PASSES = 3

SEED = 0
PKT_LEN = 16
LANES = 256
CAPACITY = 4096
TRAIN_BATCH, TRAIN_SEQ = 256, 256  # the classifier objective's batch
# the serve phase: Mixtral-8x7B (softmax SWA + MoE) at full width, 2 of 32 layers
SERVE_LAYERS, SERVE_SLOTS, SERVE_T, SERVE_NEW = 2, 4, 8192, 16
SERVE_MAX_LEN = SERVE_T + 64  # the prompt, 1 more token and the new ones fit
# kernel vs plain version on the same inputs: fp32 with another summation
# order (warp shuffles vs BLAS), so |a - b| <= ATOL + RTOL * |b|
RTOL, ATOL = 1e-4, 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3):
    """``(device_ms, call_ms)`` per call, both from CUDA events.

    ``device_ms``: ``iters`` calls captured in one CUDA graph and replayed, so
    the host's Python and launch overhead is out of the measurement.
    ``call_ms``: the same calls issued one by one from Python, which is what
    a caller that does not capture graphs pays per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / iters

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return device_ms, call_ms


def compare(name: str, got, want, atol: float = ATOL, rtol: float = RTOL) -> float:
    """Max abs error; fails beyond atol + rtol * |want| (exact for non-floats)."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            fail(f"{name}: {int((got != want).sum())} entries differ")
        return 0.0
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} entries beyond tolerance, max abs err {float(err.max()):.3e}")
    return float(err.max())


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not readable"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}", flush=True)
    return card


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library(verbose=True)
    log("build", f"library {_build.library_path().name} ready in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    for src, text in sorted(_build.build_logs.items()):
        for fn, use in ptxas_usage(text):
            log("build", f"{src} {fn}: {use}")


def ptxas_usage(text):
    """``(kernel, "R registers, S B smem, spill stores/loads")`` from nvcc's
    ``-Xptxas -v`` output, one per compiled kernel."""
    import re

    out, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:  # the kernel's name and integer template arguments, from the mangled name
            fn = m.group(1)
            names = []  # (length, name, template arguments): the shortest is the kernel's
            for num in re.finditer(r"(?=(\d+))", fn):  # every digit run and its tails
                rest, n = fn[num.start() + len(num.group(1)):], int(num.group(1))
                if rest[:n].endswith("_kernel"):
                    names.append((n, rest[:n], rest[n:]))
            if names:
                _, name, targs = min(names)
                args = (["bf16"] if "nv_bfloat16" in targs else ["f32"] if targs.startswith("If")
                        else []) + re.findall(r"L[ib](\d+)E", targs)
                fn = name + (f"<{', '.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spills {m.group(1)} B stored / {m.group(2)} B loaded"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((fn, f"{m.group(1)} registers, {smem.group(1) if smem else 0} B static "
                            f"smem, {spill}"))
            fn, spill = None, ""
    return out


# --------------------------------------------------------------------------
# 3. kernels
# --------------------------------------------------------------------------

# fill levels of the decode step's flows: none folds (all 0), the spread
# over 0..L-1 that the main-path figure uses (1 flow in L folds), all fold
DECODE_FILLS = ("none", "spread", "all")


def decode_inputs(B, heads, Gq, d, dv, m, L, with_global, seed, fill="spread"):
    """Random decode-step inputs at one of the ``DECODE_FILLS`` patterns."""
    import torch

    g = torch.Generator().manual_seed(seed)
    BH = B * heads

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to("cuda")

    def pos(*shape):  # feature-map values are positive, ~1/sqrt(m)
        return (torch.rand(shape, generator=g) / math.sqrt(m)).to("cuda")

    x = {
        "q": r(BH, Gq, d, scale=2 / math.sqrt(d)), "k_t": r(BH, d, scale=2 / math.sqrt(d)),
        "v_t": r(BH, dv), "phi_q": pos(BH, Gq, m), "phi_buf": pos(BH, L, m),
        "k_buf": r(BH, L, d, scale=2 / math.sqrt(d)), "v_buf": r(BH, L, dv),
        "S": r(BH, m, dv, scale=0.1), "Z": pos(BH, m) * L,
        "count": {"none": torch.zeros(B, dtype=torch.int32),
                  "spread": torch.arange(B, dtype=torch.int32) % L,
                  "all": torch.full((B,), L - 1, dtype=torch.int32),
                  "high": (L - 2 - torch.arange(B, dtype=torch.int32)) % L}[fill].to("cuda"),
    }
    if with_global:
        x["gnum"] = r(BH, Gq, dv, scale=0.1)
        x["gden"] = pos(BH, Gq)
    return x


def decode_cost(x, L):
    """Bytes and flops the decode step needs on these inputs (each input read
    once, each output written once; S, Z and the ring are written only where
    they change, phi_buf read only by rows that fold)."""
    BH, Gq, d = x["q"].shape
    dv, m = x["v_t"].shape[-1], x["phi_q"].shape[-1]
    heads = BH // x["count"].numel()
    c = x["count"].detach().cpu().numpy().astype(np.int64).repeat(heads)
    fold = c + 1 >= L
    g = "gnum" in x
    reads = Gq * d + d + dv + Gq * m + m * dv + m + c * (d + dv) + (Gq * dv + Gq if g else 0)
    reads = reads + fold * L * m
    writes = Gq * dv + np.where(fold, m * dv + m + L * (d + dv), d + dv)
    nbytes = 4 * int((reads + writes).sum()) + 8 * x["count"].numel()
    flops = Gq * ((c + 1) * (2 * d + 2 * dv + 2) + 2 * m * dv + 2 * m + dv + 2)
    flops = flops + fold * (2 * L * m * dv + L * m)
    return nbytes, int(flops.sum())


def bound(nbytes, flops, flops_per_s=FP32_FLOPS):
    """The least time (ms) for ``nbytes`` of HBM traffic and ``flops`` at the
    peak rate of the arithmetic the kernel uses, and which of the two binds."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_decode(with_global, timed, fill="spread", B=LANES, Gq=None, dv=None, d=None, m=None,
                 L=None, heads=None):
    """The kernel against its plain version on every output (out, S, Z, the
    ring, the new fill levels); by default at the engine's shape (the
    paper's config, 256 lanes x 4 kv-heads), each argument overriding it."""
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.kernels.decode_step import ops

    L = L or ARCH.chimera.chunk_size
    m = m or ARCH.chimera.feature_map.m
    d = d or ARCH.head_dim
    dv = dv or d
    Gq = Gq or ARCH.n_heads // ARCH.n_kv_heads
    heads = heads or ARCH.n_kv_heads
    x = decode_inputs(B, heads, Gq, d, dv, m, L, with_global, SEED + int(with_global), fill)
    kw = dict(chunk_size=L, gamma=ARCH.chimera.gamma)

    def run(fn, t):
        args = [t[k] for k in ("q", "k_t", "v_t", "phi_q", "phi_buf", "k_buf",
                               "v_buf", "S", "Z", "count")]
        return fn(*args, gnum=t.get("gnum"), gden=t.get("gden"), **kw)

    ka = {k: v.clone() for k, v in x.items()}
    pa = {k: v.clone() for k, v in x.items()}
    out_k, cnt_k = run(ops.decode_step, ka)
    out_p, cnt_p = run(ops.decode_step_plain, pa)
    torch.cuda.synchronize()
    err = max(
        compare("decode_step out", out_k, out_p),
        *(compare(f"decode_step {n}", ka[n], pa[n]) for n in ("S", "Z", "k_buf", "v_buf")),
        compare("decode_step count", cnt_k, cnt_p),
    )
    n_fold = int(((x["count"] + 1) >= L).sum()) * heads
    rec = {"max_abs_err": err}
    log("kernels", f"decode_step BH={out_k.shape[0]} Gq={Gq} d={d} dv={dv} m={m} L={L} "
                   f"layout={ops.layout(Gq, d, dv, m, L)[0]} "
                   f"globals={with_global} fill={fill} folds={n_fold}: max abs err {err:.3e} "
                   f"(tolerance {ATOL:g} + {RTOL:g}*|ref|) on out, S, Z, the ring and count")
    if timed:
        # count is not updated in place, so every timed call does the same
        # work (the same rows fold; S and Z grow, the cleared ring is reread)
        ms, call_ms = cuda_ms(lambda: run(ops.decode_step, ka), iters=50)
        plain_ms, plain_call_ms = cuda_ms(lambda: run(ops.decode_step_plain, pa), iters=20)
        nbytes, flops = decode_cost(x, L)
        bound_ms, bound_by = bound(nbytes, flops)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, call_ms=call_ms, plain_call_ms=plain_call_ms)
        log("kernels", f"decode_step fill={fill} device time: kernel {ms:.4f} ms, plain "
                       f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, "
                       f"{flops} flop); per call from Python: kernel {call_ms:.4f} ms, plain "
                       f"{plain_call_ms:.4f} ms")
    return rec


def score_inputs(B, M, seed, K=8, W=8):
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.core.symbolic import RuleSet, words_to_int32

    g = torch.Generator().manual_seed(seed)
    d = ARCH.d_model
    sig = words_to_int32(torch.randint(0, 2**32, (B, W), generator=g))
    # rules: some copy lane signatures under random masks so that both hard
    # and soft hits occur; the rest are random
    src = torch.randint(0, B, (M,), generator=g)
    masks = words_to_int32(torch.randint(0, 2**32, (M, W), generator=g))
    values = torch.where(torch.rand((M, 1), generator=g) < 0.5, sig[src],
                         words_to_int32(torch.randint(0, 2**32, (M, W), generator=g)))
    rules = RuleSet(values=values, masks=masks,
                    weights=torch.randn((M,), generator=g),
                    hard=torch.rand((M,), generator=g) < 0.3).to("cuda")
    params = {
        "cls": {"w": (torch.randn((d, K), generator=g) / math.sqrt(d)).to("cuda")},
        "anom": {"w": (torch.randn((d, 1), generator=g) / math.sqrt(d)).to("cuda")},
        "fusion": {"alpha": torch.tensor(1.0, device="cuda"),
                   "beta": torch.tensor(1.0, device="cuda")},
    }
    pooled = torch.randn((B, d), generator=g).to("cuda")
    sticky = (torch.rand((B,), generator=g) < 0.1).to("cuda")
    return params, rules, pooled, sig.to("cuda"), sticky


def score_cost(params, rules, pooled, sig):
    B, d = pooled.shape
    K = params["cls"]["w"].shape[1]
    M, W = rules.values.shape
    nbytes = 4 * (B * d + B * W + d * K + d + 2 * M * W + M + 2) + B + M
    nbytes += 4 * B * (K + 3) + B
    flops = B * (2 * d * (K + 1) + 3 * M * W + 2 * M + 6)
    return nbytes, flops


def check_score(M, timed, K=8, W=8, B=LANES):
    """The kernel against its plain version at B rows (by default the
    engine's 256 lanes) with M rules; K classes and W signature words other
    than 8 take its generic path."""
    import torch
    from repro_torch.kernels.flow_ingest import ops

    params, rules, pooled, sig, sticky = score_inputs(B, M, SEED + M, K, W)
    out_k, st_k = ops.flow_score(params, rules, pooled, sig, sticky)
    out_p, st_p = ops.flow_score_plain(params, rules, pooled, sig, sticky)
    torch.cuda.synchronize()
    err = max(compare(f"flow_score {k}", out_k[k], out_p[k]) for k in out_p)
    compare("flow_score sticky", st_k, st_p)
    hard_hits = int(out_p["hard_hit"].sum())
    rec = {"max_abs_err": err}
    log("kernels", f"flow_score B={B} M={M} K={K} W={W} hard={hard_hits}: max abs err "
                   f"{err:.3e} (tolerance {ATOL:g} + {RTOL:g}*|ref|)")
    if timed:
        ms, call_ms = cuda_ms(lambda: ops.flow_score(params, rules, pooled, sig, sticky),
                              iters=200)
        plain_ms, plain_call_ms = cuda_ms(
            lambda: ops.flow_score_plain(params, rules, pooled, sig, sticky), iters=50)
        floor_ms = launch_floor_ms(B)
        nbytes, flops = score_cost(params, rules, pooled, sig)
        bound_ms, bound_by = bound(nbytes, flops)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   floor_ms=floor_ms, bytes=nbytes, flops=flops, call_ms=call_ms,
                   plain_call_ms=plain_call_ms)
        log("kernels", f"flow_score device time: kernel {ms:.5f} ms, launch floor (an empty "
                       f"kernel on the same grid) {floor_ms:.5f} ms, plain {plain_ms:.4f} ms, "
                       f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B, {flops} flop); "
                       f"per call from Python: kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms")
    return rec


def launch_floor_ms(B):
    """Device time of an empty kernel on flow_score's grid for B lanes,
    timed as the kernels are (``cuda_ms``, 200 launches in a graph)."""
    import torch
    from repro_torch.kernels import _build

    lib = _build.load_library()

    def empty():
        _build.check(lib.empty_launch(B, torch.cuda.current_stream().cuda_stream), "empty")

    return cuda_ms(empty, iters=200)[0]


# chimera_attention partials are sums of up to T terms of size ~1 (|num|
# and den reach a few hundred at T 256), so fp32 in another summation order
# differs by up to ~T * 6e-8 * |terms|: atol 1e-4, rtol 1e-4
ATTN_ATOL = 1e-4


def chimera_inputs(B, Hkv, Gq, T, m, seed, requires_grad=False, d=None, dv=None):
    """Normalized q, k, random v and their exp_prf features from the paper's
    feature map (public layout (B, Hkv, Gq, T, .)), on the card; d is the
    paper's head width unless given, and dv = d unless given."""
    import dataclasses

    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.core.feature_maps import _normalize, apply_feature_map, init_feature_map

    fm = dataclasses.replace(ARCH.chimera.feature_map, m=m)
    d = d or ARCH.head_dim
    dv = dv or d
    g = torch.Generator().manual_seed(seed)
    fm_params = init_feature_map(fm, d, g, "cuda")
    q = _normalize(torch.randn((B, Hkv, Gq, T, d), generator=g).to("cuda"), fm.input_scale)
    k = _normalize(torch.randn((B, Hkv, T, d), generator=g).to("cuda"), fm.input_scale)
    v = torch.randn((B, Hkv, T, dv), generator=g).to("cuda")
    xs = [q, k, v, apply_feature_map(fm, fm_params, q), apply_feature_map(fm, fm_params, k)]
    return [x.detach().requires_grad_(requires_grad) for x in xs]


def chimera_cost(B, Hkv, Gq, T, d, dv, m, L):
    """Bytes and flops of the partials: causal pairs inside each chunk, the
    stream readout of chunks 1.. and the fold of chunks ..n-2 (chunk 0 reads
    a zero state and the last fold is never read)."""
    BH, n = B * Hkv, T // L
    reads = BH * (Gq * T * d + T * d + T * dv + (Gq + 1) * (n - 1) * L * m)
    writes = BH * Gq * T * (dv + 1)
    pairs = L * (L + 1) // 2
    flops = BH * (Gq * n * pairs * (2 * d + 2 * dv + 2)
                  + Gq * (n - 1) * L * (2 * m * dv + 2 * m)
                  + (n - 1) * (2 * L * m * dv + L * m))
    return 4 * (reads + writes), flops


def check_chimera(timed, shape=None, seed=SEED + 5):
    """The kernel against its plain version at ``shape`` = (B, Hkv, Gq, T,
    m, L), the train phase's unless given (d = dv the paper's)."""
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.kernels.chimera_attention import ops

    B, Hkv, Gq, T, m, L = shape or (
        TRAIN_BATCH, ARCH.n_kv_heads, ARCH.n_heads // ARCH.n_kv_heads, TRAIN_SEQ,
        ARCH.chimera.feature_map.m, ARCH.chimera.chunk_size)
    d = ARCH.head_dim
    q, k, v, pq, pk = chimera_inputs(B, Hkv, Gq, T, m, seed)
    BH = B * Hkv
    flat = [q.reshape(BH, Gq, T, d), k.reshape(BH, T, d), v.reshape(BH, T, d),
            pq.reshape(BH, Gq, T, m), pk.reshape(BH, T, m)]
    with torch.no_grad():
        num_k, den_k = ops.chimera_attention_bh(*flat, chunk_size=L)
        num_p, den_p = ops.chimera_attention_partials_plain(q, k, v, pq, pk, L)
    torch.cuda.synchronize()
    err = max(compare("chimera_attention num", num_k, num_p.reshape(BH, Gq, T, d), atol=ATTN_ATOL),
              compare("chimera_attention den", den_k, den_p.reshape(BH, Gq, T), atol=ATTN_ATOL))
    rec = {"max_abs_err": err, "shape": f"BH {BH} Gq {Gq} T {T} d=dv {d} m {m} L {L}"}
    log("kernels", f"chimera_attention BH={BH} Gq={Gq} T={T} d={d} m={m} L={L}: max abs err "
                   f"{err:.3e} (tolerance {ATTN_ATOL:g} + {RTOL:g}*|ref|; |den| up to "
                   f"{float(den_p.max()):.1f})")
    for use_local, use_stream in ((True, False), (False, True)):
        with torch.no_grad():
            a = ops.chimera_attention_bh(*flat, chunk_size=L, use_local=use_local,
                                         use_stream=use_stream)
            b = ops.chimera_attention_partials_plain(q, k, v, pq, pk, L, use_local, use_stream)
        for name, x, y in zip(("num", "den"), a, b):
            compare(f"chimera_attention {name} local={use_local} stream={use_stream}",
                    x, y.reshape(x.shape), atol=ATTN_ATOL)
    if timed:
        with torch.no_grad():
            ms, call_ms = cuda_ms(lambda: ops.chimera_attention_bh(*flat, chunk_size=L), iters=20)
            plain_ms, plain_call_ms = cuda_ms(
                lambda: ops.chimera_attention_partials_plain(q, k, v, pq, pk, L), iters=5)
            parts = {mode: cuda_ms(lambda mode=mode: ops.chimera_attention_bh(
                *flat, chunk_size=L, use_local=mode[0], use_stream=mode[1]), iters=20)[0]
                for mode in ((True, False), (False, True))}
        log("kernels", f"chimera_attention device time by part: local only "
                       f"{parts[True, False]:.4f} ms, stream only {parts[False, True]:.4f} ms")
        nbytes, flops = chimera_cost(B, Hkv, Gq, T, d, d, m, L)
        bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
        fp32_ms = flops / FP32_FLOPS * 1e3
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, call_ms=call_ms, plain_call_ms=plain_call_ms)
        log("kernels", f"chimera_attention device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                       f"ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B; {flops} flop, "
                       f"x{TF32_PASSES} in TF32 on the tensor cores: "
                       f"{TF32_PASSES * flops / TF32_FLOPS * 1e3:.4f} ms; on the fp32 CUDA cores "
                       f"they would take {fp32_ms:.4f} ms); per call from Python: kernel "
                       f"{call_ms:.4f} ms, plain {plain_call_ms:.4f} ms")
    return rec


CHIMERA_EDGE_CHUNKS = (16, 32, 64, 128)
CHIMERA_MODES = ((True, True), (True, False), (False, True), (False, False))


# (L, m, d = dv) off the paper's phi tile: the smoke configs' widths (L 16,
# m 16, d 16) and the 16-column tile at every chunk size
CHIMERA_SMOKE_EDGES = ((16, 16, 16), (16, 32, 16), (32, 32, 32), (64, 32, 16), (128, 16, 16),
                       (64, 16, 64))


def check_chimera_edge(L, T, use_local, use_stream, m=64, d=None, exact=False, dv=None):
    """The kernel against its plain version at one edge shape of its
    contract (B 2 x Hkv 2, Gq 2, m 64, the paper's d and dv = d unless
    given); returns the max abs error.  ``exact``: the plain version
    evaluated in float64 on the same inputs, so that the tolerance measures
    the kernel's rounding alone."""
    import torch
    from repro_torch.kernels.chimera_attention import ops

    q, k, v, pq, pk = chimera_inputs(2, 2, 2, T, m, SEED + 8 + L + T + m, d=d, dv=dv)
    flat = [x.flatten(0, 1) for x in (q, k, v, pq, pk)]
    ref = [x.double() for x in (q, k, v, pq, pk)] if exact else (q, k, v, pq, pk)
    with torch.no_grad():
        a = ops.chimera_attention_bh(*flat, chunk_size=L, use_local=use_local,
                                     use_stream=use_stream)
        b = ops.chimera_attention_partials_plain(*ref, L, use_local, use_stream)
    return max(compare(f"chimera_attention {name} L={L} T={T} m={m} d={q.shape[-1]} "
                       f"dv={v.shape[-1]} Gq=2 "
                       f"local={use_local} stream={use_stream}", x, y.reshape(x.shape),
                       atol=ATTN_ATOL)
               for name, x, y in zip(("num", "den"), a, b))


def check_chimera_edges():
    """Every chunk size, a single chunk (T = L) and four, every
    (use_local, use_stream) pair; then the same at CHIMERA_SMOKE_EDGES."""
    worst = max(check_chimera_edge(L, T, *mode) for L in CHIMERA_EDGE_CHUNKS
                for T in (L, 4 * L) for mode in CHIMERA_MODES)
    log("kernels", f"chimera_attention edge shapes (L 16-128, T = L and 4L, Gq 2, m 64, every "
                   f"local/stream pair): max abs err {worst:.3e} (tolerance {ATTN_ATOL:g} + "
                   f"{RTOL:g}*|ref|)")
    worst = max(check_chimera_edge(L, T, *mode, m=m, d=d) for L, m, d in CHIMERA_SMOKE_EDGES
                for T in (L, 4 * L) for mode in CHIMERA_MODES)
    log("kernels", f"chimera_attention off the paper's phi tile ((L, m, d = dv) in "
                   f"{list(CHIMERA_SMOKE_EDGES)}, T = L and 4L, every local/stream pair): max abs "
                   f"err {worst:.3e} (tolerance {ATTN_ATOL:g} + {RTOL:g}*|ref|)")


def check_decode_edges():
    """The kernel against its plain version at the edge shapes of its
    contract: every fill pattern, Gq 1 and 2, dv 16, 32, 64 and 128, with and
    without the static globals (64 lanes x 4 kv-heads), and at the smoke
    configs' widths (d = dv 16, m 16, L 16)."""
    for fill in DECODE_FILLS:
        for Gq in (1, 2):
            for with_global in (False, True):
                for dv in (16, 32, 64, 128):
                    check_decode(with_global, timed=False, fill=fill, B=64, Gq=Gq, dv=dv)
                check_decode(with_global, timed=False, fill=fill, B=64, Gq=Gq, dv=16, d=16,
                             m=16, L=16)


# the model zoo's default Chimera widths (L 256, d = dv = m = 128), where
# decode_step stages the ring in tiles and chimera_attention runs
# csrc/chimera_attention_long.cu: Mixtral-8x7B's serve shape (4 slots x 8
# kv-heads, Gq 4), yi-9b's and qwen3-32b's Gq 8 and codeqwen1.5-7b's Gq 1
# (4 slots x 32 kv-heads)
ZOO_L, ZOO_D, ZOO_M = 256, 128, 128
ZOO_DECODE = ((4, 8, 4), (4, 8, 8), (4, 32, 1))  # (slots, kv-heads, Gq)
ZOO_FILLS = DECODE_FILLS + ("high",)  # "high": rings of 251-254 rows, no fold


def check_decode_wide():
    """decode_step at the zoo's widths against its plain version under
    every fill pattern, with and without the static globals; the Mixtral
    shape is timed with its globals (the serve path's 32 of them)."""
    recs = {}
    for B, heads, Gq in ZOO_DECODE:
        for fill in ZOO_FILLS:
            for with_global in (False, True):
                timed = (B, heads, Gq) == ZOO_DECODE[0] and with_global and fill in (
                    "spread", "all")
                r = check_decode(with_global, timed, fill=fill, B=B, Gq=Gq, d=ZOO_D, dv=ZOO_D,
                                 m=ZOO_M, L=ZOO_L, heads=heads)
                if timed:
                    recs[fill] = r
    return recs


# the prefill shape: Mixtral's 4 slots x 8 kv-heads, Gq 4, T 8192
LONG_SHAPE = (4, 8, 4, 8192)
# chimera_attention partials at T 8192 are sums of up to 8192 terms (den
# reaches ~10^4), so fp32 in another summation order than the plain
# version's (a blocked cuBLAS product over dense T x T scores) differs by
# more than at the train shape's T 256: atol 1e-3 and rtol 1e-4 there;
# the edge shapes (T <= 1024) keep ATTN_ATOL
LONG_ATOL = 1e-3


def long_plain(q, k, v, pq, pk, L, use_local=True, use_stream=True):
    """The plain version at the prefill shape, one (batch, kv-head) row at a
    time: it forms (Gq, T, T) fp32 scores, 1 GB a row at T 8192."""
    import torch
    from repro_torch.kernels.chimera_attention import ops

    B, Hkv = q.shape[:2]
    num, den = [], []
    for b in range(B):
        for h in range(Hkv):
            sl = [x[b:b + 1, h:h + 1] for x in (q, k, v, pq, pk)]
            n_, d_ = ops.chimera_attention_partials_plain(*sl, L, use_local, use_stream)
            num.append(n_[0, 0])
            den.append(d_[0, 0])
    return torch.stack(num), torch.stack(den)


def profiled_kernel_ms(fn, names, iters=20):
    """Device ms per launch of each kernel whose name holds one of
    ``names`` (each launched once per call), from a profiler trace of
    ``iters`` calls of ``fn`` after one warm-up call; returns {name: (ms,
    launches the trace holds)}, None for a name it does not hold.  Late in a
    long process the trace drops the device events of its first tens of ms
    (on an H100, 17 of 20 calls of 2.7 ms), so the calls are framed by
    idle time and each time is a mean over the launches the trace holds."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.5)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.5)
    us, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        for name in names:
            if name in ev.key and dev_us:
                us[name] += dev_us
                count[name] += ev.count
    return {x: (us[x] / 1e3 / count[x], count[x]) if count[x] else None for x in names}


# the long-chunk kernel's three kernels, as a profiler names them
LONG_KERNELS = ("chimera_fold_kernel", "chimera_prefix_kernel", "chimera_chunk_kernel")


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def check_chimera_long(timed, shape=None):
    """csrc/chimera_attention_long.cu against the plain version at ``shape``
    = (B, Hkv, Gq, T, d, dv), the Mixtral prefill shape (LONG_SHAPE, d = dv
    128) unless given; timed, beside its local-only and stream-only parts
    and the device time of each of its three kernels in a profiler trace of
    the whole call."""
    import torch
    from repro_torch.kernels.chimera_attention import ops

    B, Hkv, Gq, T, d, dv = shape or LONG_SHAPE + (ZOO_D, ZOO_D)
    L, m = ZOO_L, ZOO_M
    q, k, v, pq, pk = chimera_inputs(B, Hkv, Gq, T, m, SEED + 9, d=d, dv=dv)
    BH = B * Hkv
    flat = [q.reshape(BH, Gq, T, d), k.reshape(BH, T, d), v.reshape(BH, T, dv),
            pq.reshape(BH, Gq, T, m), pk.reshape(BH, T, m)]
    with torch.no_grad():
        num_k, den_k = ops.chimera_attention_bh(*flat, chunk_size=L)
        num_p, den_p = long_plain(q, k, v, pq, pk, L)
    torch.cuda.synchronize()
    err = max(compare("chimera_attention L256 num", num_k, num_p, atol=LONG_ATOL),
              compare("chimera_attention L256 den", den_k, den_p, atol=LONG_ATOL))
    rec = {"max_abs_err": err,
           "shape": f"BH {BH} Gq {Gq} T {T} d {d} dv {dv} m {m} L {L}, chimera_attention_long.cu"}
    log("kernels", f"chimera_attention (long-chunk kernel) BH={BH} Gq={Gq} T={T} d={d} dv={dv} "
                   f"m={m} L={L}: max abs err {err:.3e} (tolerance {LONG_ATOL:g} + {RTOL:g}*|ref|; "
                   f"|den| up to {float(den_p.max()):.1f}, |num| up to "
                   f"{float(num_p.abs().max()):.1f})")
    del num_p, den_p
    if timed:
        with torch.no_grad():
            ms, call_ms = cuda_ms(lambda: ops.chimera_attention_bh(*flat, chunk_size=L), iters=5)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            long_plain(q, k, v, pq, pk, L)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            parts = {mode: cuda_ms(lambda mode=mode: ops.chimera_attention_bh(
                *flat, chunk_size=L, use_local=mode[0], use_stream=mode[1]), iters=5)[0]
                for mode in ((True, False), (False, True))}
            traced = profiled_kernel_ms(lambda: ops.chimera_attention_bh(*flat, chunk_size=L),
                                        LONG_KERNELS)
        fold_ms, prefix_ms, chunk_ms = (traced[x] and traced[x][0] for x in LONG_KERNELS)
        held = [traced[x] and traced[x][1] for x in LONG_KERNELS]
        nbytes, flops = chimera_cost(B, Hkv, Gq, T, d, dv, m, L)
        bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
        fp32_ms = flops / FP32_FLOPS * 1e3
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, call_ms=call_ms, local_ms=parts[True, False],
                   stream_ms=parts[False, True], fold_ms=fold_ms, prefix_ms=prefix_ms,
                   chunk_ms=chunk_ms)
        log("kernels", f"chimera_attention L256 BH={BH} Gq={Gq} d={d} dv={dv} device time: "
                       f"kernel {ms:.4f} ms (local only "
                       f"{parts[True, False]:.4f} ms, stream only {parts[False, True]:.4f} ms; "
                       f"in a profiler trace of 20 calls, per launch: fold {fmt_ms(fold_ms)}, "
                       f"prefix {fmt_ms(prefix_ms)}, chunk kernel {fmt_ms(chunk_ms)}; launches "
                       f"the trace holds {held}), plain "
                       f"{plain_ms:.1f} ms (host clock over its {BH} rows), bound {bound_ms:.4f} "
                       f"ms by {bound_by} ({nbytes} B; {flops} flop, x{TF32_PASSES} in TF32 on "
                       f"the tensor cores; on the fp32 CUDA cores {fp32_ms:.4f} ms); per call "
                       f"from Python {call_ms:.4f} ms")
    del q, k, v, pq, pk, flat, num_k, den_k
    torch.cuda.empty_cache()
    return rec


# (d, dv, m) of the long-chunk kernel's edge shapes: d = dv at every dv it
# takes, at m 16 (one m-tile: the fold's single-tile pair) and m 128 (the
# zoo's); m 144 (a second fold slice of one m-tile, a readout slice of
# 16); m 320 (five readout slices, a second fold slice of 64 features);
# d != dv (d 64, dv 128; MLA's d 96, dv 64), and d % 16
# == 8 (the score loop's odd tail: d 24 at dv 32 with m 16, d 40 at dv 64
# with m 48, three m-tiles), all on the kernel's runtime-d instantiation
LONG_EDGE_WIDTHS = (tuple((d, d, m) for d in (16, 32, 64, 128) for m in (16, 128))
                    + ((128, 128, 144), (128, 128, 320), (64, 128, 128), (24, 32, 16),
                       (40, 64, 48), (96, 64, 128)))


def check_chimera_long_edges():
    """The long-chunk kernel at T = L, 3L and 4L, every (use_local,
    use_stream) pair, at every (d, dv, m) of LONG_EDGE_WIDTHS, against the plain
    version in float64: at T = 4L and m 16 the stream terms reach ~700
    where a partial is ~1, and the float32 plain version's own rounding
    takes up to 0.85 of the tolerance there."""
    worst = 0.0
    for d, dv, m in LONG_EDGE_WIDTHS:
        for T in (ZOO_L, 3 * ZOO_L, 4 * ZOO_L):
            for mode in CHIMERA_MODES:
                worst = max(worst, check_chimera_edge(ZOO_L, T, *mode, m=m, d=d, exact=True,
                                                      dv=dv))
    log("kernels", f"chimera_attention (long-chunk kernel) edge shapes (L {ZOO_L}, T = L, 3L "
                   f"and 4L, every local/stream pair, (d, dv, m) in {list(LONG_EDGE_WIDTHS)}): "
                   f"max abs err {worst:.3e} against the plain version in float64 (tolerance "
                   f"{ATTN_ATOL:g} + {RTOL:g}*|ref|)")


def build_other_library(csrc_dir):
    """Another tree's kernel sources (``csrc_dir/*.cu``), built with this
    tree's flags into ``build/`` beside it and loaded with this tree's C
    signatures: for timing two versions of a kernel in one process."""
    import ctypes
    from pathlib import Path

    from repro_torch.kernels import _build

    srcs = sorted(Path(csrc_dir).glob("*.cu"))
    if not srcs:
        fail(f"no CUDA sources in {csrc_dir}")
    out = _build.BUILD_DIR / f"other_{_build.source_hash(Path(csrc_dir))}"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = [(x, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", str(x), "-o",
                                   str(out / (x.stem + ".o"))],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for x in srcs]
    for x, pr in procs:
        text, _ = pr.communicate()
        if pr.returncode:
            fail(f"nvcc failed for {x}:\n{text}")
    lib_path = out / "lib.so"
    res = subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(lib_path),
                          *(str(out / (x.stem + ".o")) for x in srcs)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        fail(f"link failed:\n{res.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):  # an older tree may lack a measurement aid
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _build.RESTYPES.get(name, ctypes.c_int)
    return lib


def compare_builds(others, rounds=1, only=None):
    """decode_step (the engine's shape, each fill pattern, with globals),
    flow_score (the engine's 256 lanes, one rule at 8 signature words and
    two at the compiled program's 24), int_flow_score (the program phase's
    cases: 256 lanes, W 24, M 1 and 300), chimera_attention (the train
    phase's shape, and the prefill shape at L 256 with its local-only and
    stream-only parts), window_attention (the serve phase's prefill) and
    its backward (bf16, at the train-softmax phase's two training shapes,
    on o and lse from this tree's forward) from this tree and from the
    trees of ``others`` (``{label: csrc directory}``), timed in turns on one
    card: each round runs this, the others, then the others and this again
    in reverse (this, other, other, this for one).  ``only``: the case
    names' prefixes to time (all if None).  Prints each version's times and
    returns ``{kernel: {version: [ms, ...]}}``."""
    import dataclasses

    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.configs.mixtral_8x7b import CONFIG as MIX
    from repro_torch.kernels import _build
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.flow_ingest import int_ops
    from repro_torch.kernels.flow_ingest import ops as sops
    from repro_torch.kernels.window_attention import ops as wops

    libs = {"this": _build.load_library()}
    libs.update({label: build_other_library(d) for label, d in others.items()})
    L, m, d = ARCH.chimera.chunk_size, ARCH.chimera.feature_map.m, ARCH.head_dim
    Gq, heads = ARCH.n_heads // ARCH.n_kv_heads, ARCH.n_kv_heads
    cases = {}
    for fill in DECODE_FILLS:
        x = decode_inputs(LANES, heads, Gq, d, d, m, L, True, SEED + 1, fill)
        args = [x[k] for k in ("q", "k_t", "v_t", "phi_q", "phi_buf", "k_buf", "v_buf", "S",
                               "Z", "count")]
        cases[f"decode_step fill={fill}"] = (
            lambda a=args, x=x: dops.decode_step(*a, chunk_size=L, gamma=ARCH.chimera.gamma,
                                                 gnum=x["gnum"], gden=x["gden"]), 50)
    q, k, v, pq, pk = chimera_inputs(TRAIN_BATCH, heads, Gq, TRAIN_SEQ, m, SEED + 5)
    flat = [q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1), pq.flatten(0, 1),
            pk.flatten(0, 1)]
    cases["chimera_attention"] = (lambda: cops.chimera_attention_bh(*flat, chunk_size=L), 20)
    B, Hkv, GqL, T = LONG_SHAPE  # the long-chunk kernel at the prefill shape, and its parts
    lq, lk, lv, lpq, lpk = chimera_inputs(B, Hkv, GqL, T, ZOO_M, SEED + 9, d=ZOO_D)
    lflat = [lq.flatten(0, 1), lk.flatten(0, 1), lv.flatten(0, 1), lpq.flatten(0, 1),
             lpk.flatten(0, 1)]
    for label, mode in (("", (True, True)), (" local only", (True, False)),
                        (" stream only", (False, True))):
        cases[f"chimera_attention L256{label}"] = (
            lambda mode=mode: cops.chimera_attention_bh(*lflat, chunk_size=ZOO_L,
                                                        use_local=mode[0], use_stream=mode[1]), 5)
    sargs = score_inputs(LANES, 1, SEED + 1)
    cases["flow_score M=1"] = (lambda: sops.flow_score(*sargs), 200)
    sargs24 = score_inputs(LANES, 2, SEED + 2, W=24)  # the compiled program's layout
    cases["flow_score M=2 W=24"] = (lambda: sops.flow_score(*sargs24), 200)
    ccfg, params = paper_classifier()
    for M in (1, 300):
        iargs = int_score_case(params, dataclasses.replace(ccfg, sig_words=24), M, SEED + 70 + M)
        cases[f"int_flow_score M={M}"] = (lambda a=iargs: int_ops.int_flow_score(*a), 200)
    wq, wk, wv = window_inputs(SERVE_SLOTS, MIX.n_heads, MIX.n_kv_heads, SERVE_T, MIX.head_dim,
                               MIX.head_dim, SEED + 20)
    cases["window_attention"] = (
        lambda: wops.sliding_window_attention(wq, wk, wv, MIX.sliding_window), 2)
    for shape, seed in zip(window_bwd_shapes(), (SEED + 80, SEED + 82)):
        B, H, Hkv, T, W, d, dv = shape
        bq, bk, bv = window_inputs(B, H, Hkv, T, d, dv, seed, torch.bfloat16)
        bdo = torch.randn((B, H, T, dv), generator=torch.Generator().manual_seed(seed + 1000))
        bo, blse = wops.window_attention_fwd(bq, bk, bv, W)
        cases[f"window_attention_bwd H {H} (Hkv {Hkv}) W {W} d {d} dv {dv} bf16"] = (
            lambda a=(bq, bk, bv, bo, blse, bdo.to("cuda", torch.bfloat16), W):
            wops.window_attention_bwd(*a), 2)
    if only is not None:
        cases = {name: c for name, c in cases.items() if name.startswith(tuple(only))}
    times = {name: {ver: [] for ver in libs} for name in cases}
    try:
        for ver in (list(libs) + list(libs)[::-1]) * rounds:
            _build._lib = libs[ver]
            for name, (fn, iters) in cases.items():
                with torch.no_grad():
                    times[name][ver].append(cuda_ms(fn, iters=iters)[0])
    finally:
        _build._lib = libs["this"]
    for name, t in times.items():
        log("compare", f"{name}: " + "; ".join(
            f"{ver} {', '.join(f'{x:.5f}' for x in ts)} ms" for ver, ts in t.items()))
    return times


def check_chimera_grads(B=2, Hkv=2, Gq=2, T=128, m=64, L=64):
    """The autograd Function (the forward kernel, then the backward kernels
    of csrc/chimera_attention_bwd.cu) against autograd through the plain
    version, at a small shape with Gq 2 unless given another."""
    import torch
    from repro_torch.kernels.chimera_attention import ops

    xs = chimera_inputs(B, Hkv, Gq, T, m, SEED + 6, requires_grad=True)
    g = torch.Generator().manual_seed(SEED + 7)
    w_num = torch.randn(xs[0].shape[:-1] + (xs[2].shape[-1],), generator=g).to("cuda")
    w_den = torch.randn(xs[0].shape[:-1], generator=g).to("cuda")
    before, bwd_before = ops.launches, ops.bwd_launches
    outs = []
    for fn in (ops.chimera_attention_partials, ops.chimera_attention_partials_plain):
        num, den = fn(*xs, L)
        loss = (num * w_num).sum() + (den * w_den).sum()
        outs.append((num, den, torch.autograd.grad(loss, xs)))
    want = ops.bwd_kernel_launches(T, L)
    if ops.launches == before or ops.bwd_launches - bwd_before != want:
        fail(f"chimera_attention gradient check: the Function launched {ops.launches - before} "
             f"forward and {ops.bwd_launches - bwd_before} backward kernels (want >= 1 and "
             f"{want})")
    err = max(compare("chimera_attention fwd num", outs[0][0], outs[1][0], atol=ATTN_ATOL),
              compare("chimera_attention fwd den", outs[0][1], outs[1][1], atol=ATTN_ATOL))
    gerr = max(compare(f"chimera_attention grad {n}", a, b, atol=ATTN_ATOL)
               for n, a, b in zip(("q", "k", "v", "phi_q", "phi_k"), outs[0][2], outs[1][2]))
    log("kernels", f"chimera_attention Function (B {B}, Hkv {Hkv}, Gq {Gq}, T {T}, m {m}, L "
                   f"{L}): forward max "
                   f"abs err {err:.3e}, gradients of q, k, v, phi_q, phi_k (the backward kernels) "
                   f"max abs err {gerr:.3e} against autograd through the plain version")


# window_attention outputs are convex combinations of rows of v (|v| ~ 1):
# fp32 against the plain version's cuBLAS products differs by ~1e-6, held to
# ATOL + RTOL * |ref|.  bf16: the kernel rounds its fp32 result once, so it is
# held to the plain version on the fp32 inputs rounded to bf16, within two
# bf16 ulps near 1 (atol = rtol = 8e-3).
WIN_BF16_TOL = 8e-3
# query heads per slice of the plain version at the prefill shape: it forms
# (BH, T, T) fp32 scores, 2.1 GB per slice at T 8192, 34 GB for all 128
WIN_PLAIN_HEADS = 8


def window_inputs(B, H, Hkv, T, d, dv, seed, dtype=None):
    import torch

    g = torch.Generator().manual_seed(seed)
    dtype = dtype or torch.float32
    return [torch.randn(shape, generator=g).to("cuda", dtype)
            for shape in ((B, H, T, d), (B, Hkv, T, d), (B, Hkv, T, dv))]


def window_cost(B, H, Hkv, T, W, d, dv, esize=4):
    """Bytes and flops of the windowed attention with elements of ``esize``
    bytes (fp32 unless given): each of q, k, v (per kv-head, as the kernel
    takes them) read once and o written once; QK^T and PV over the in-band
    pairs only (min(i + 1, W) keys for row i)."""
    n1 = min(T, W)
    pairs = n1 * (n1 + 1) // 2 + (T - n1) * W
    nbytes = esize * (B * H * T * (d + dv) + B * Hkv * T * (d + dv))
    return nbytes, B * H * pairs * (2 * d + 2 * dv)


# (T, W, dtype, H, Hkv) of the edge shapes, each at every (d, dv) of
# WINDOW_EDGE_DIMS (B 2): ragged T, W below a tile, W > T, W = T and T + 1
# (full-causal attention: blockwise_softmax_attention's route), a tile
# boundary (T 128, W 64), W a multiple of the tile with T not, W = 1 (the
# diagonal alone), T = W + 1 over a tile boundary, and 1, 2 and 4 kv-heads;
# the backward runs each in fp32 and bf16
WINDOW_EDGES = (
    (200, 48, "float32", 4, 1), (200, 300, "float32", 4, 1), (77, 13, "float32", 2, 2),
    (200, 48, "bfloat16", 4, 1), (200, 48, "float32", 8, 4), (128, 64, "float32", 4, 2),
    (200, 128, "float32", 4, 2), (200, 128, "bfloat16", 8, 4), (200, 200, "float32", 4, 1),
    (200, 201, "float32", 4, 2), (77, 77, "bfloat16", 2, 2), (77, 1, "float32", 4, 2),
    (129, 128, "bfloat16", 4, 1),
)
# the (d, dv) of the edge shapes: the zoo's 64 and 128, the smoke configs'
# 16 and 32, and MLA's (96, 64) at full width and (24, 16) at the smoke size
WINDOW_EDGE_DIMS = ((64, 64), (128, 128), (16, 16), (32, 32), (96, 64), (24, 16))


def check_window_edge(T, W, dtype, H, Hkv, d, seed, dv=None):
    """The kernel against its plain version at one edge shape (B 2, dv = d
    unless given); fp32 within ATOL + RTOL * |ref|, bf16 within WIN_BF16_TOL
    of the plain version's fp32 result rounded to bf16.  Returns the max abs
    error."""
    import torch
    from repro_torch.kernels.window_attention import ops

    dt = getattr(torch, dtype)
    dv = dv or d
    xs = window_inputs(2, H, Hkv, T, d, dv, seed, dt)
    with torch.no_grad():
        got = ops.sliding_window_attention(*xs, W)
        want = ops.sliding_window_attention_plain(*(x.float() for x in xs), W)
    name = f"window_attention T {T} W {W} d {d} dv {dv} {dt}"
    if dt == torch.bfloat16:
        if got.dtype != torch.bfloat16:
            fail(f"{name}: output dtype {got.dtype}")
        e = compare(name, got.float(), want.to(dt).float(), atol=WIN_BF16_TOL, rtol=WIN_BF16_TOL)
        tol = f"{WIN_BF16_TOL:g} + {WIN_BF16_TOL:g}*|ref|"
    else:
        e = compare(name, got, want)
        tol = f"{ATOL:g} + {RTOL:g}*|ref|"
    log("kernels", f"{name}, B 2 x H {H} (Hkv {Hkv}): max abs err {e:.3e} (tolerance {tol})")
    return e


def check_window(timed, shape=None):
    """The kernel against its plain version at ``shape`` = (B, H, Hkv, T, W,
    d, dv), the serve phase's prefill shape unless given (the plain version
    run over slices of WIN_PLAIN_HEADS query heads); with the default, also
    at the edge shapes; timed at ``shape``."""
    import torch
    from repro_torch.configs.mixtral_8x7b import CONFIG as MIX
    from repro_torch.kernels.window_attention import ops

    B, H, Hkv, T, W, d, dv = shape or (SERVE_SLOTS, MIX.n_heads, MIX.n_kv_heads, SERVE_T,
                                       MIX.sliding_window, MIX.head_dim, MIX.head_dim)
    G = H // Hkv
    q, k, v = window_inputs(B, H, Hkv, T, d, dv, SEED + 20)
    slices = [(b, h0) for b in range(B) for h0 in range(0, H, WIN_PLAIN_HEADS)]

    def plain(b, h0):
        kv = slice(h0 // G, (h0 + WIN_PLAIN_HEADS) // G)
        return ops.sliding_window_attention_plain(
            q[b:b + 1, h0:h0 + WIN_PLAIN_HEADS], k[b:b + 1, kv], v[b:b + 1, kv], W)

    with torch.no_grad():
        out = ops.sliding_window_attention(q, k, v, W)
        err = max(compare(f"window_attention b {b} heads {h0}..{h0 + WIN_PLAIN_HEADS - 1}",
                          out[b:b + 1, h0:h0 + WIN_PLAIN_HEADS], plain(b, h0))
                  for b, h0 in slices)
    rec = {"max_abs_err": err,
           "shape": f"B {B} x H {H} (Hkv {Hkv}) T {T} W {W} d {d} dv {dv}"}
    log("kernels", f"window_attention B {B} x H {H} (Hkv {Hkv}) T {T} W {W} d {d} dv {dv}: max "
                   f"abs err {err:.3e} (tolerance {ATOL:g} + {RTOL:g}*|ref|) against the plain "
                   f"version over {len(slices)} slices of {WIN_PLAIN_HEADS} heads")
    if shape is None:
        for i, edge in enumerate(WINDOW_EDGES):
            for dk, dvk in WINDOW_EDGE_DIMS:
                check_window_edge(*edge, dk, SEED + 21 + i, dv=dvk)
    if timed:
        with torch.no_grad():
            ms, call_ms = cuda_ms(lambda: ops.sliding_window_attention(q, k, v, W), iters=2)
            plain_ms, _ = cuda_ms(lambda: [plain(b, h0) for b, h0 in slices], iters=1)
            # the yardstick: one PyTorch call on the same function, K and V
            # repeated to the query heads, the band as a boolean mask (none
            # where W >= T: causal)
            idx = torch.arange(T, device="cuda")
            band = ((idx[:, None] - idx[None, :]) >= 0) & ((idx[:, None] - idx[None, :]) < W)
            ke, ve = (x.repeat_interleave(G, dim=1) for x in (k, v))
            from torch.nn.attention import SDPBackend, sdpa_kernel

            def sdpa():  # the memory-efficient backend: the math one forms (BH, T, T)
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    if W >= T:
                        return torch.nn.functional.scaled_dot_product_attention(
                            q, ke, ve, is_causal=True)
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, ke, ve, attn_mask=band)

            try:
                lib_err = float((sdpa() - out).abs().max())
                library_ms, _ = cuda_ms(sdpa, iters=1)
            except RuntimeError as e:  # no backend of that list takes these widths
                log("kernels", f"window_attention: scaled_dot_product_attention refused "
                               f"d {d} dv {dv}: {str(e)[:200]}")
                lib_err = library_ms = None
        del ke, ve
        nbytes, flops = window_cost(B, H, Hkv, T, W, d, dv)
        bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
        fp32_ms = flops / FP32_FLOPS * 1e3
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, bytes=nbytes, flops=flops, call_ms=call_ms)
        log("kernels", f"window_attention device time at B {B} x H {H} (Hkv {Hkv}) T {T} W {W} "
                       f"d {d} dv {dv}: kernel {ms:.4f} ms (per call from Python "
                       f"{call_ms:.4f} ms), bound "
                       f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B; {flops} flop, "
                       f"x{TF32_PASSES} in TF32 on the tensor cores; on the fp32 CUDA cores "
                       f"they would take {fp32_ms:.4f} ms); "
                       f"scaled_dot_product_attention (memory-efficient backend) "
                       f"{fmt_ms(library_ms)} (max abs diff to the kernel {lib_err}); plain "
                       f"version {plain_ms:.4f} "
                       f"ms over its {len(slices)} slices of {WIN_PLAIN_HEADS} heads (it forms "
                       f"(BH, T, T) fp32 scores)")
    del q, k, v, out
    torch.cuda.empty_cache()
    return rec


# window_attention's non-causal mode (the encoder of whisper-tiny and its
# softmax cross-attention): (Tq, Tk, dtype, H, Hkv) of the edge shapes,
# each at every (d, dv) of WINDOW_EDGE_DIMS (B 2): Tq != Tk both ways, Tk
# not a multiple of the 64-key tile, Tq = 1 (a decode tick's query against
# the encoder's 1,536 frames, and against a ragged Tk), one key, Tq not a
# multiple of the 128-row block, 2 and 3 query heads a kv-head, fp32 and bf16
NONCAUSAL_EDGES = (
    (256, 1536, "float32", 4, 4), (1, 1536, "float32", 6, 6), (1, 1536, "bfloat16", 6, 6),
    (200, 77, "float32", 4, 2), (77, 200, "bfloat16", 4, 1), (1, 77, "float32", 4, 4),
    (129, 1, "float32", 2, 2), (100, 100, "bfloat16", 6, 2), (300, 130, "float32", 6, 3),
)
# the encoder's shape at whisper-tiny's full width: B 8 segments x H 6, Tq =
# Tk = Te 1,536 frames (30 s of audio, padded), d = dv = 64
WHISPER_ENC_SHAPE = (8, 6, 6, 1536, 1536, 64, 64)


def noncausal_cost(B, H, Hkv, Tq, Tk, d, dv, esize=4):
    """Bytes (q, k, v per kv-head read once, o written once) and flops (QK^T
    and PV over every pair) of the non-causal mode."""
    nbytes = esize * (B * H * Tq * (d + dv) + B * Hkv * Tk * (d + dv))
    return nbytes, B * H * Tq * Tk * (2 * d + 2 * dv)


def check_noncausal_edge(Tq, Tk, dtype, H, Hkv, d, dv, seed):
    """The non-causal mode against its plain version at one edge shape (B 2);
    tolerances as check_window_edge's.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.window_attention import ops

    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to("cuda", dt)
               for shape in ((2, H, Tq, d), (2, Hkv, Tk, d), (2, Hkv, Tk, dv)))
    with torch.no_grad():
        got = ops.noncausal_attention(q, k, v)
        want = ops.noncausal_attention_plain(q.float(), k.float(), v.float())
    name = f"window_attention non-causal Tq {Tq} Tk {Tk} d {d} dv {dv} {dt}"
    if dt == torch.bfloat16:
        if got.dtype != torch.bfloat16:
            fail(f"{name}: output dtype {got.dtype}")
        return compare(name, got.float(), want.to(dt).float(), atol=WIN_BF16_TOL,
                       rtol=WIN_BF16_TOL)
    return compare(name, got, want)


def check_noncausal(timed=True):
    """The non-causal mode at the encoder's shape (WHISPER_ENC_SHAPE) in
    float32 (the main path's type: the encoder's q, k and v come out of
    float32 weights) and bfloat16, against its plain version (dense (BH, T,
    T) scores), then at every edge shape x (d, dv); timed at the encoder's
    shape against its bound and scaled_dot_product_attention(is_causal=False)
    (the library call, PyTorch's choice of backend).  A call that needs a
    gradient is checked at one segment of that shape in both types
    (check_noncausal_bwd).  Returns the two shapes' records."""
    import torch
    from repro_torch.kernels.window_attention import ops

    B, H, Hkv, Tq, Tk, d, dv = WHISPER_ENC_SHAPE
    recs = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        g = torch.Generator().manual_seed(SEED + 80)
        q, k, v = (torch.randn(shape, generator=g).to("cuda", dt)
                   for shape in ((B, H, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, dv)))
        with torch.no_grad():
            out = ops.noncausal_attention(q, k, v)
            want = ops.noncausal_attention_plain(q.float(), k.float(), v.float())
        if dt == torch.bfloat16:
            err = compare(f"window_attention non-causal {dtype}", out.float(),
                          want.to(dt).float(), atol=WIN_BF16_TOL, rtol=WIN_BF16_TOL)
            tol = f"{WIN_BF16_TOL:g} + {WIN_BF16_TOL:g}*|ref|"
        else:
            err = compare(f"window_attention non-causal {dtype}", out, want)
            tol = f"{ATOL:g} + {RTOL:g}*|ref|"
        del want
        shape = f"whisper-tiny encoder, B {B} x H {H} Tq = Tk {Tq} d {d} dv {dv} {dtype}"
        rec = {"max_abs_err": err, "shape": shape}
        log("kernels", f"window_attention non-causal at {shape}: max abs err {err:.3e} "
                       f"(tolerance {tol}) against the plain version")
        if timed:
            with torch.no_grad():
                ms, call_ms = cuda_ms(lambda: ops.noncausal_attention(q, k, v), iters=20)
                plain_ms, _ = cuda_ms(lambda: ops.noncausal_attention_plain(q, k, v), iters=3)
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=False)
                lib_err = float((sdpa().float() - out.float()).abs().max())
                library_ms, _ = cuda_ms(sdpa, iters=20)
            nbytes, flops = noncausal_cost(B, H, Hkv, Tq, Tk, d, dv, esize=q.element_size())
            if dt == torch.bfloat16:
                bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
                rate = "bf16 at 989 TFLOP/s"
            else:
                bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
                rate = f"x{TF32_PASSES} in TF32 at 495 TFLOP/s (split fp32)"
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms, call_ms=call_ms)
            log("kernels", f"window_attention non-causal device time at {shape}: kernel "
                           f"{ms:.4f} ms (per call from Python {call_ms:.4f} ms), bound "
                           f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B; {flops} flop, {rate}); "
                           f"scaled_dot_product_attention(is_causal=False) {library_ms:.4f} ms "
                           f"(max abs diff to the kernel {lib_err:.3e}); plain version "
                           f"{plain_ms:.4f} ms (dense (BH, T, T) scores)")
        recs[dtype] = rec
        del q, k, v, out
        torch.cuda.empty_cache()
        # a call that needs a gradient: the Function's forward with lse and the
        # backward kernels' non-causal mode, at one segment of the encoder's shape
        check_noncausal_bwd((1, H, Hkv, Tq, Tk, d, dv), dtype, SEED + 79, phase="kernels")
    worst = 0.0
    for i, (Tq_, Tk_, dtype, H_, Hkv_) in enumerate(NONCAUSAL_EDGES):
        for dk, dvk in WINDOW_EDGE_DIMS:
            worst = max(worst, check_noncausal_edge(Tq_, Tk_, dtype, H_, Hkv_, dk, dvk,
                                                    SEED + 81 + i))
    log("kernels", f"window_attention non-causal at {len(NONCAUSAL_EDGES)} edge shapes x "
                   f"{len(WINDOW_EDGE_DIMS)} (d, dv): every one within its tolerance, max abs err "
                   f"{worst:.3e}")
    return recs


def check_decode_fills():
    """decode_step at the engine's shape under each fill pattern, without
    and with the static globals; the globals' run is timed."""
    recs = {}
    for fill in DECODE_FILLS:
        check_decode(with_global=False, timed=False, fill=fill)
        recs[fill] = check_decode(with_global=True, timed=True, fill=fill)
    log("kernels", "decode_step by fill pattern (kernel / bound ms): " + ", ".join(
        f"{f} {r['ms']:.4f} / {r['bound_ms']:.4f}" for f, r in recs.items()))
    return recs


def phase_kernels():
    recs = {}
    fills = check_decode_fills()
    recs["decode_step"] = dict(fills["spread"], fills={
        f: {k: r[k] for k in ("ms", "bound_ms", "bytes", "flops")} for f, r in fills.items()})
    check_decode_edges()
    recs["flow_score"] = check_score(M=1, timed=True)
    check_score(M=300, timed=False)
    check_score(M=40, timed=False, K=5, W=3)
    recs["chimera_attention"] = check_chimera(timed=True)
    check_chimera_edges()
    check_chimera_grads()
    recs["window_attention"] = check_window(timed=True)
    for r in check_noncausal().values():
        other_shape(recs, "window_attention", r)
    return recs


# --------------------------------------------------------------------------
# 4. engine (the serving path)
# --------------------------------------------------------------------------

def paper_classifier(n_global=None, n_layers=None):
    """The paper's classifier with random weights from SEED (optionally with
    another static-global set size, or cut to ``n_layers`` of its layers)."""
    import dataclasses

    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.train import classifier as C

    arch = ARCH
    if n_global is not None:
        arch = dataclasses.replace(ARCH, chimera=dataclasses.replace(ARCH.chimera, n_global=n_global))
    if n_layers is not None:
        arch = dataclasses.replace(arch, n_layers=n_layers)
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256, sig_words=8)
    params = C.init_classifier(ccfg, torch.Generator().manual_seed(SEED))
    return ccfg, params


ENGINE_BATCHES = 3  # timed protocol-mix batches per engine
# the engine and program phases, adapt (a) and shard (b) (through the
# launcher's ``arch``) serve FLOW_LAYERS of the paper model's 4 layers:
# their engines are host-bound and their time grows with the layers
# (PERF.md section 4 lists the depth cuts and what each saved)
FLOW_LAYERS = 1


class OpCount:
    """Counts PyTorch operator calls (each a dispatch on the host; the
    non-view ones launch device work) while it is entered."""

    VIEWS = ("view", "_unsafe_view", "unsqueeze", "permute", "select", "slice", "transpose",
             "expand", "squeeze", "t", "reshape", "alias")

    def __enter__(self):
        import collections

        from torch.utils._python_dispatch import TorchDispatchMode

        ops = self.ops = collections.Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops[func.__name__.split(".")[0]] += 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    @property
    def total(self):
        return sum(self.ops.values())

    @property
    def views(self):
        return sum(n for k, n in self.ops.items() if k in self.VIEWS)


def phase_engine(recs):
    """The serving path, two engines from one set of weights on the same
    traffic: the per-round engine (the figures of earlier runs) and the fused engine
    (a CUDA graph per chunk width) behind ``AsyncIngestPipeline``.  Each
    runs a warm-up batch (whose host operator calls are counted),
    ENGINE_BATCHES timed protocol-mix batches, 2 rule-violating batches and
    one profiled batch, with the kernels' launch counters zeroed just
    before and read just after; the two must count the same launches."""
    import torch
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.flow_ingest import ops as sops
    from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig
    from repro_torch.serve.ingest_pipeline import AsyncIngestPipeline
    from repro_torch.train import classifier as C

    ccfg, params = paper_classifier(n_layers=FLOW_LAYERS)
    packets = 256
    mix = FlowScenario(kind="protocol-mix", pkt_len=PKT_LEN, packets_per_batch=packets, seed=SEED)
    bad = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=packets,
                       seed=SEED, fid_base=1 << 32)
    rules = C.default_rules(ccfg, bad.anomaly_signature)
    warm = mix.next_batch()
    timed = [mix.next_batch() for _ in range(ENGINE_BATCHES)]
    bads = [bad.next_batch() for _ in range(2)]
    profiled = mix.next_batch()
    n_batches = 1 + ENGINE_BATCHES + 2 + 1

    def check(out, P, what):
        for k in ("trust", "s_nn", "s_sym"):
            if out[k].shape != (P,):
                fail(f"engine {what}: {k} of shape {out[k].shape}, not ({P},)")
            bad = np.flatnonzero(~np.isfinite(out[k]))
            if len(bad):
                fail(f"engine {what}: {k} not finite at {len(bad)} packets, "
                     f"e.g. {bad[:8].tolist()}: {out[k][bad[:8]].tolist()}")
        if not (out["trust"][out["vetoed"]] == 1.0).all():
            fail(f"engine {what}: a vetoed packet has trust != 1.0")
        return out

    results = {}
    for label in ("per-round", "fused"):
        fused = label == "fused"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        budget = torch.cuda.mem_get_info()[0]  # the table may hold what the card holds
        fcfg = FlowEngineConfig(capacity=CAPACITY, lanes=LANES, state_budget_bytes=budget,
                                fused=fused)
        t0 = time.perf_counter()
        engine = FlowEngine(ccfg, params, rules, fcfg, device="cuda")
        log("engine", f"{label}: paper-config FlowEngine on cuda: capacity {CAPACITY}, lanes "
                      f"{LANES}, {engine.per_flow_state_bytes()} B/flow, resident_state_bytes "
                      f"{engine.resident_state_bytes()}, built in {time.perf_counter() - t0:.2f} s")
        layouts = []
        if fused:
            t0 = time.perf_counter()
            n_widths = engine.warm_fused(PKT_LEN)
            graphs = engine.fused_graphs()
            log("engine", f"fused: {len(graphs)} graph captures (widths "
                          f"{sorted(w for w, _ in graphs)}) in {time.perf_counter() - t0:.2f} s, "
                          f"capture times " + ", ".join(
                              f"w {w} {g.capture_s:.2f} s" for (w, _), g in sorted(graphs.items()))
                          + f"; decode_step / flow_score launches held per graph: "
                          f"{next(iter(graphs.values())).launches}")
            if len(graphs) != n_widths:
                fail(f"engine: warm_fused made {n_widths} widths ready but captured {len(graphs)}")
            pipe = AsyncIngestPipeline(engine)
            real = engine._dispatch_fused

            def dispatch(*a, _real=real, **k):  # records each batch's widths and chunks
                pending = _real(*a, **k)
                layouts.append([(w, len(ch)) for _, w, ch in pending.layout])
                return pending

            engine._dispatch_fused = dispatch

            def ingest(b, what):
                return check(pipe.ingest(b["flow_ids"], b["tokens"]), len(b["flow_ids"]), what)

            def ingest_many(bs):
                for b in bs:
                    pipe.submit(b["flow_ids"], b["tokens"])
                return [check(o, len(b["flow_ids"]), f"{label} timed {i}")
                        for i, (o, b) in enumerate(zip(pipe.drain(), bs))]
        else:
            def ingest(b, what):
                return check(engine.ingest(b["flow_ids"], b["tokens"]), len(b["flow_ids"]), what)

            def ingest_many(bs):
                return [ingest(b, f"{label} timed {i}") for i, b in enumerate(bs)]

        # the main path: counters zeroed just before, read just after
        dops.launches = sops.launches = 0
        with OpCount() as ops:
            rounds0 = engine.stats.rounds
            ingest(warm, f"{label} warm-up")
            warm_rounds = engine.stats.rounds - rounds0
        torch.cuda.synchronize()
        replays0 = engine._graphs.replays if fused else 0
        rounds0 = engine.stats.rounds
        t0 = time.perf_counter()
        ingest_many(timed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = engine.stats.rounds - rounds0
        replays = (engine._graphs.replays - replays0) if fused else 0
        vetoed = sum(int(ingest(b, f"{label} rule-violating")["vetoed"].sum()) for b in bads)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            ingest(profiled, f"{label} profiled")
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t1
        launches = {"decode_step": dops.launches, "flow_score": sops.launches}
        if vetoed == 0:
            fail(f"engine {label}: no packet of the rule-violating batches was vetoed")
        if min(launches.values()) == 0:
            fail(f"engine {label}: a kernel was never launched on the main path: {launches}")
        n_pkts = sum(len(b["flow_ids"]) for b in timed)
        pps = n_pkts / wall
        log("engine", f"{label}: {n_pkts} protocol-mix packets in {ENGINE_BATCHES} batches, "
                      f"{rounds} arrival rounds, {wall:.3f} s: {pps:.1f} packets/s, "
                      f"{rounds / wall:.2f} rounds/s; rule-violating vetoes {vetoed}")
        log("engine", f"{label}: launches in the main-path run ({n_batches} batches, "
                      f"{engine.stats.rounds} rounds): {launches}; per batch "
                      + ", ".join(f"{k} {v / n_batches:.1f}" for k, v in launches.items())
                      + f"; per round decode_step {launches['decode_step'] / engine.stats.rounds:.1f}")
        log("engine", f"{label}: host operator calls for the warm-up batch ({warm_rounds} "
                      f"rounds): {ops.total} ({ops.views} views), {ops.total / warm_rounds:.1f} "
                      f"per round; top: " + ", ".join(f"{k} {n}" for k, n in
                                                      ops.ops.most_common(5)))
        if not fused:  # the fused engine's chunks are 8-32 wide: see the profiler's line below
            for name, n in launches.items():
                per_batch = n / n_batches * recs[name]["ms"]
                log("engine", f"{label}: {name}: {per_batch:.3f} ms of kernel device time per "
                              f"batch (launches per batch x phase 3's CUDA-event device ms per "
                              f"launch)")
        busy, by_kernel = report_profile(prof, prof_wall, f"{label}: one protocol-mix batch")
        for name in launches:  # the port's kernels, as the profiler saw them in this batch
            hits = [(ms, n) for key, (ms, n) in by_kernel.items() if f"{name}_kernel" in key]
            if hits:
                ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
                log("engine", f"{label}: {name} in the profiled batch: {n} launches, {ms:.3f} ms, "
                              f"{ms / n:.5f} ms per launch")
        if fused:
            log("engine", f"fused: graph replays per batch {replays / ENGINE_BATCHES:.1f} "
                          f"(timed batches); widths x chunks per batch: " + "; ".join(
                              " ".join(f"{w}x{n}" for w, n in lay) for lay in layouts[:n_batches]))
            report_fused_device_time(engine, layouts[1 : 1 + ENGINE_BATCHES], wall, layouts[-1],
                                     prof_wall, busy)
        else:
            report_ops_per_token(engine)
        log("engine", f"{label}: resident_state_bytes {engine.resident_state_bytes()}, "
                      f"max_memory_allocated {torch.cuda.max_memory_allocated()}, memory_reserved "
                      f"{torch.cuda.memory_reserved()} (the graph pool included)")
        results[label] = {"pps": pps, "launches": launches}
        del engine, ingest, ingest_many  # the next engine's peak memory is its own
    if results["fused"]["launches"] != results["per-round"]["launches"]:
        fail(f"engine: fused launches {results['fused']['launches']} differ from the per-round "
             f"engine's {results['per-round']['launches']} on the same traffic")
    log("engine", f"fused vs per-round on the same traffic: launches equal "
                  f"({results['fused']['launches']}); packets/s {results['fused']['pps']:.1f} vs "
                  f"{results['per-round']['pps']:.1f} "
                  f"({results['fused']['pps'] / results['per-round']['pps']:.2f}x)")
    return {"launches": {k: sum(r["launches"][k] for r in results.values())
                         for k in ("decode_step", "flow_score")}}


def report_fused_device_time(engine, timed_layouts, timed_wall, layout, wall, busy):
    """Device time of the fused engine's graphs, by CUDA events: one replay
    of the flow step's graph at each width the batches used, and the
    phi-of-the-ring work the step holds (``apply_feature_map`` on the ring
    with the arriving key, once per token and layer), captured alone at the
    same shapes.  Summed over the chunks of the timed batches (against their
    wall time: the busy share without the profiler) and of the profiled
    batch (beside the profiler's kernel time), with the ring's phi share."""
    import torch
    from repro_torch.core.feature_maps import _normalize, apply_feature_map
    from repro_torch.models.model import index_params

    arch = engine.ccfg.arch
    ch = arch.chimera
    L, d, Hkv = ch.chunk_size, arch.head_dim, arch.n_kv_heads
    fm_params = index_params(engine.params["backbone"]["blocks"]["b0"]["attn"]["chimera"]["fm"], 0)
    per_chunk = arch.n_layers * PKT_LEN  # phi of the ring: once per token and layer
    g = torch.Generator().manual_seed(SEED + 60)
    step_ms, phi_ms = {}, {}
    for w in sorted({w for lay in timed_layouts + [layout] for w, _ in lay}):
        graph = engine._graphs.capture(w, PKT_LEN)
        graph.inp.zero_()
        graph.inp[:, 0] = engine.fcfg.capacity  # scratch lanes: replays touch the scratch row
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(2):
            graph.graph.replay()
        start.record()
        for _ in range(5):
            graph.graph.replay()
        end.record()
        torch.cuda.synchronize()
        step_ms[w] = start.elapsed_time(end) / 5
        kh = _normalize(torch.randn((w, Hkv, d), generator=g).to("cuda"), ch.feature_map.input_scale)
        k_buf = torch.randn((w, Hkv, L, d), generator=g).to("cuda")
        count = torch.randint(0, L, (w,), generator=g, dtype=torch.int32).to("cuda")

        def phi():
            slot = (torch.arange(L, device="cuda")[None, :] == count[:, None])[:, None, :, None]
            return apply_feature_map(ch.feature_map, fm_params,
                                     torch.where(slot, kh[:, :, None, :], k_buf))

        phi_ms[w] = cuda_ms(phi, iters=per_chunk)[0] * per_chunk
    chunks = [(w, n) for w, n in layout]
    step_total = sum(n * step_ms[w] for w, n in chunks)
    phi_total = sum(n * phi_ms[w] for w, n in chunks)
    timed_step = sum(n * step_ms[w] for lay in timed_layouts for w, n in lay)
    timed_phi = sum(n * phi_ms[w] for lay in timed_layouts for w, n in lay)
    log("engine", "fused: device time per graph replay (CUDA events): " + ", ".join(
        f"w {w} {step_ms[w]:.3f} ms (phi of the ring {phi_ms[w]:.3f} ms, "
        f"{phi_ms[w] / step_ms[w]:.3f})" for w in sorted(step_ms)))
    log("engine", f"fused: profiled batch {' '.join(f'{w}x{n}' for w, n in chunks)}: graph "
                  f"replays {step_total:.1f} ms of device time by CUDA events (busy share "
                  f"{step_total / (wall * 1e3):.3f} of its {wall * 1e3:.1f} ms wall; the "
                  f"profiler's {'not measured' if busy is None else f'{busy:.1f} ms'}), of "
                  f"which phi of the ring {phi_total:.1f} ms ({phi_total / step_total:.3f})")
    log("engine", f"fused: the {len(timed_layouts)} timed batches: graph replays "
                  f"{timed_step:.1f} ms of device time by CUDA events over {timed_wall * 1e3:.1f} "
                  f"ms wall, busy share {timed_step / (timed_wall * 1e3):.3f}; phi of the ring "
                  f"{timed_phi:.1f} ms ({timed_phi / timed_step:.3f})")


def report_ops_per_token(engine):
    """PyTorch operator calls for one decode token through every layer."""
    import torch
    from repro_torch.models import model as M

    lanes = engine.fcfg.lanes
    dev = engine.device
    caches = M.init_caches(engine.ccfg.arch, lanes, dtype=torch.float32, device=dev)
    tok = torch.zeros((lanes,), dtype=torch.long, device=dev)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    with OpCount() as c:
        M.decode_hidden_step(engine.ccfg.arch, engine.params["backbone"], tok, pos, caches)
    log("engine", f"PyTorch operator calls per decode token ({engine.ccfg.arch.n_layers} "
                  f"layers): {c.total}, of which {c.views} views; top: "
                  + ", ".join(f"{k} {n}" for k, n in c.ops.most_common(6)))


def report_profile(p, wall, what):
    """Device time by kernel for one profiled run, and the device's busy
    share; returns ``(kernel ms, {kernel name: (ms, count)})``, or ``(None,
    {})`` where none was reported."""
    rows = []
    for ev in p.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if getattr(ev, "device_type", None) is not None and "CUDA" not in str(ev.device_type):
            continue
        if ev.key in SSM_SCOPES:  # a scope's span on the device, not a kernel
            continue
        if dev_us:
            rows.append((dev_us, ev.key, ev.count))
    if not rows:
        log("profile", f"{what}: device time not measured (the profiler reported none)")
        return None, {}
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log("profile", f"{what}: wall {wall * 1e3:.1f} ms, kernel time "
                   f"{busy_us / 1e3:.1f} ms, device busy share {busy_us / 1e3 / (wall * 1e3):.3f}")
    for dev_us, key, count in rows[:12]:
        log("profile", f"{dev_us / 1e3:9.3f} ms {count:7d}x  {key[:90]}")
    return busy_us / 1e3, {key: (dev_us / 1e3, count) for dev_us, key, count in rows}


# --------------------------------------------------------------------------
# 5. train (the training path)
# --------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_WARMUP, EVAL_BATCHES = 20, 2, 2


def packet_stream(seed, batch=TRAIN_BATCH, seq=TRAIN_SEQ, step=0):
    from repro_torch.data.pipeline import PacketStream

    return PacketStream(n_classes=8, vocab_size=512, batch_size=batch, seq_len=seq,
                        anomaly_rate=0.1, seed=seed, step=step)


def check_losses(name, losses):
    import torch

    losses = losses.detach().cpu()
    if not torch.isfinite(losses).all():
        fail(f"{name}: non-finite loss {losses.tolist()}")
    return [float(x) for x in losses]


def phase_train(recs):
    """The classifier objective at the paper's width (the LM objective runs
    through the Trainer in the trainer phase)."""
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.flow_ingest import ops as sops
    from repro_torch.train import classifier as C

    ccfg, params = paper_classifier()
    s = packet_stream(SEED + 50)
    t0 = time.perf_counter()
    for _ in range(3):
        s.next_batch()
    data_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.reset_peak_memory_stats()

    # the main path: counters zeroed just before, read just after
    dops.launches = sops.launches = cops.launches = cops.bwd_launches = 0
    # the classifier objective (benchmarks/common.py's loop)
    C.train_classifier(ccfg, packet_stream(SEED + 100), params, steps=TRAIN_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, rules, losses = C.train_classifier(ccfg, packet_stream(SEED), params,
                                                steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_step": dops.launches, "flow_score": sops.launches,
                "chimera_attention": cops.launches, "chimera_attention_bwd": cops.bwd_launches}
    if launches["chimera_attention"] == 0 or launches["chimera_attention_bwd"] == 0:
        fail(f"train: chimera_attention's forward or backward was never launched on the "
             f"training path: {launches}")
    losses = check_losses("train classifier", losses)
    # held-out batches of the same traffic, far past the training steps
    ev = C.eval_classifier(ccfg, trained, rules, packet_stream(SEED, step=1000),
                           batches=EVAL_BATCHES)

    n_layers = ARCH.n_layers
    ms = wall / TRAIN_STEPS * 1e3
    log("train", f"classifier objective, paper width, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
                 f"{TRAIN_STEPS} steps in {wall:.3f} s after {TRAIN_WARMUP} warm-up steps: "
                 f"{ms:.2f} ms/step, {TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3):.0f} tokens/s "
                 f"(host data {data_ms:.2f} ms per batch, inside the loop)")
    log("train", f"classifier loss first {losses[0]:.5f} last {losses[-1]:.5f}; held-out "
                 f"macro-F1 {ev['f1']:.4f} (precision {ev['pr']:.4f}, recall {ev['rc']:.4f}, "
                 f"{EVAL_BATCHES} batches)")
    per_step = launches["chimera_attention"] / (TRAIN_WARMUP + TRAIN_STEPS)
    log("train", f"launches in the training run: {launches}; chimera_attention {per_step:.1f} "
                 f"per classifier step ({n_layers} layers), so "
                 f"{per_step * recs['chimera_attention']['ms']:.3f} ms of kernel device time per "
                 f"step (phase 3's ms per launch)")
    log("train", f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
    profile_train_step(ccfg, trained, rules)
    return {"launches": launches, "ms_per_step": ms}


def profile_train_step(ccfg, params, rules):
    """One classifier step under the profiler, forward and backward (with
    the AdamW update) in two profiler runs, so each has its own breakdown."""
    import torch
    from repro_torch.optim.optimizer import AdamWConfig, adamw_update, init_optimizer, tree_flatten
    from repro_torch.train import classifier as C

    batch = C.batch_to_device(packet_stream(SEED + 2).next_batch(), "cuda")
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=TRAIN_STEPS)
    opt = init_optimizer(params, ocfg)
    leaves, unflatten = tree_flatten(params)
    xs = [p.detach().requires_grad_(True) for p in leaves]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as pf:
        t0 = time.perf_counter()
        loss, _ = C.classifier_loss(ccfg, unflatten(xs), rules, batch)
        torch.cuda.synchronize()
        fwd_wall = time.perf_counter() - t0
    with torch.profiler.profile(activities=acts) as pb:
        t0 = time.perf_counter()
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
        adamw_update(ocfg, params, unflatten(grads), opt)
        torch.cuda.synchronize()
        bwd_wall = time.perf_counter() - t0
    report_profile(pf, fwd_wall, "one classifier step, forward")
    report_profile(pb, bwd_wall, "one classifier step, backward + AdamW")


# --------------------------------------------------------------------------
# 6. serve (the LM serving path: Mixtral-8x7B, softmax SWA + MoE)
# --------------------------------------------------------------------------

def mixtral_softmax(n_layers, **replace):
    """Mixtral-8x7B's softmax variant (``launch/dryrun.py --no-chimera``),
    cut to ``n_layers`` of its 32 layers, optionally narrowed."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("mixtral-8x7b"), use_chimera=False,
                               n_layers=n_layers, **replace)


def phase_serve(recs):
    """``ServeEngine`` at Mixtral's full width, 2 of 32 layers (all 32 in
    fp32 would be 187 GB): prefill_batch of 4 prompts of T + 1 tokens (a
    T = 8192 prefill through the window kernel, T > W), then 16 new tokens
    per slot through decode_step over the ring KV cache."""
    import torch
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.flow_ingest import ops as sops
    from repro_torch.kernels.window_attention import ops as wops
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_flatten
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = mixtral_softmax(SERVE_LAYERS)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_flatten(params)[0])
    log("serve", f"{cfg.name} softmax SWA + MoE, {cfg.n_layers} of 32 layers at full width (d "
                 f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv-heads, head_dim "
                 f"{cfg.head_dim}, {cfg.moe_experts} experts top-{cfg.moe_top_k} d_ff "
                 f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}, window {cfg.sliding_window}, capacity "
                 f"factor {cfg.capacity_factor}, dtype {cfg.dtype}): {nbytes // 4} fp32 "
                 f"parameters ({nbytes} B) drawn on the card in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                         device="cuda")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (SERVE_SLOTS, SERVE_T + 1))
    reqs = [Request(rid=i, prompt=p.tolist(), max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    # warm-up at the main path's shapes (cuBLAS picks its kernels on a first
    # call), with the prefill's logits checked: finite, of the padded vocab
    tokens = torch.from_numpy(prompts[:, :SERVE_T]).to("cuda")
    tok = torch.zeros((SERVE_SLOTS,), dtype=torch.long, device="cuda")
    pos = torch.full((SERVE_SLOTS,), SERVE_T, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, caches = M.prefill_with_caches(cfg, params, tokens, max_len=SERVE_MAX_LEN)
        M.decode_step(cfg, params, tok, pos, caches)
    if tuple(logits.shape) != (SERVE_SLOTS, cfg.padded_vocab) or not torch.isfinite(logits).all():
        fail(f"serve: prefill logits of shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    del logits, caches

    # the main path: counters zeroed just before, read just after
    wops.launches = cops.launches = dops.launches = sops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill_batch(reqs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.run_until_done()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = {"window_attention": wops.launches, "chimera_attention": cops.launches,
                "decode_step": dops.launches, "flow_score": sops.launches}
    peak = torch.cuda.max_memory_allocated()

    want = cfg.n_layers * 1  # one launch per layer and prefill
    if launches["window_attention"] != want:
        fail(f"serve: window_attention launched {launches['window_attention']} times, want "
             f"{want} (layers x prefills): {launches}")
    for r in reqs:
        if not r.done or len(r.generated) != SERVE_NEW:
            fail(f"serve: request {r.rid} generated {len(r.generated)} of {SERVE_NEW} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            fail(f"serve: request {r.rid} emitted an id outside the vocabulary")
    ticks, emitted = engine.stats.ticks, engine.stats.tokens_emitted
    if emitted != SERVE_SLOTS * SERVE_NEW:
        fail(f"serve: {emitted} tokens emitted, want {SERVE_SLOTS * SERVE_NEW}")
    n_prefill = SERVE_SLOTS * SERVE_T
    log("serve", f"prefill_batch {SERVE_SLOTS} x {SERVE_T} tokens: {prefill_s * 1e3:.1f} ms, "
                 f"{n_prefill / prefill_s:.0f} tokens/s")
    log("serve", f"decode: {ticks} ticks ({SERVE_SLOTS} slots, the prompts' last tokens then "
                 f"{SERVE_NEW} new each) in {decode_s * 1e3:.1f} ms: {decode_s / ticks * 1e3:.2f} "
                 f"ms per tick, {emitted / decode_s:.1f} tokens/s")
    log("serve", f"launches in the main-path run: {launches} (window_attention = {cfg.n_layers} "
                 f"layers x 1 prefill): {want * recs['window_attention']['ms']:.1f} ms of "
                 f"window_attention device time per prefill (phase 3's ms per launch)")
    log("serve", f"max_memory_allocated {peak} B during serving (parameters {nbytes} B)")
    log("serve", "greedy generations (first 8 ids): "
                 + "; ".join(f"{r.rid}: {r.generated[:8]}" for r in reqs))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        M.prefill_with_caches(cfg, params, tokens, max_len=SERVE_MAX_LEN)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    report_profile(prof, prof_wall, f"one prefill of {SERVE_SLOTS} x {SERVE_T} tokens")
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        M.decode_step(cfg, params, tok, pos, engine.caches)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    report_profile(prof, prof_wall, f"one decode_step of {SERVE_SLOTS} slots (no engine "
                                    "bookkeeping)")
    del engine, params
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": prefill_s, "decode_s": decode_s}


# --------------------------------------------------------------------------
# 11. lm-chimera (Chimera prefill and LM serving at the zoo's default widths)
# --------------------------------------------------------------------------

# the ragged prompt of part (c): 2 chunks of 256 and a tail of 128
# prefilled (4 x 640 tokens split into the MoE's dispatch groups of 512,
# in both packages)
RAGGED_T, RAGGED_NEW = 641, 4
# full width, bf16 activations: kernel against plain version, or prefill
# against token-by-token decode, differ in fp32 summation orders, which can
# move the bf16 residual stream by one rounding (2^-8 relative) at some
# entries; logits are held within LM_LOGIT_TOL (abs, + the same relative;
# measured 8.7e-3 to 1.4e-2 on an H100 for the Chimera variants, against
# 3.4 where the MoE drops tokens in one run and not the other), and a
# greedy token wherever the reference's top-2 margin exceeds twice it.  The
# full-causal softmax variants read 3.38e-2 and 3.32e-2, within it only by
# its relative term; with float32 activations on both routes the same
# comparison reads 2.9e-6 and 3.6e-6 (softmax_logits_fp32, on an H100
# 80GB HBM3 at 700 W), so the bf16 residual stream, not window_attention,
# is the cause of that gap
LM_LOGIT_TOL = 3e-2
LM_MARGIN = 2 * LM_LOGIT_TOL
# the softmax variants' kernel against plain version again with float32
# activations on both routes (the same weights, prompts, generations and
# depth), so that no bf16 rounding of the residual stream stands between
# them: fp32 sums in other orders (the kernel's split-TF32 products against
# cuBLAS fp32), ~1e-5 expected, within LM_LOGIT_FP32_TOL (abs, + the same
# relative).  An attention error of one bf16 rounding (2^-9 relative) at
# every entry would move the logits by ~1e-2, as the bf16 runs' are moved.
LM_LOGIT_FP32_TOL = 1e-3
SMOKE_LM = ("chimera-dataplane", "mixtral-8x7b", "codeqwen1.5-7b", "yi-9b", "qwen3-32b",
            "moonshot-v1-16b-a3b", "chameleon-34b", "minicpm3-4b")
# and these configs' full-causal softmax variants (MiniCPM3-4B's MLA with its
# latent cache, Yi-9B's GQA), card against CPU at the smoke size and held at
# full width, 2 layers, in the lm-mla phase
SOFTMAX_LM = ("minicpm3-4b", "yi-9b")
# served at full width through the LM launcher, 2 layers each (m 128, L 256,
# n_global 32, d_head 128): Mixtral-8x7B's Chimera variant (Gq 4, 8 experts
# top-2), Moonshot-v1-16B-A3B (Gq 1, 64 experts top-6 and 2 shared experts,
# vocabulary 163,840), Chameleon-34B (dense, Gq 8, qk-norm, d 8192)
ZOO_LM = ("mixtral-8x7b", "moonshot-v1-16b-a3b", "chameleon-34b")


def attn_widths(cfg):
    """(kv-heads, Gq, q/k width, v width) of the heads the attention kernels
    see: MLA's materialized heads (H of them, Gq 1), else the GQA heads."""
    if cfg.attention_kind == "mla":
        return cfg.n_heads, 1, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim or cfg.head_dim
    return cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.head_dim


def attn_label(cfg):
    if cfg.attention_kind == "mla":
        return (f"MLA q_lora {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} heads of q/k width "
                f"{cfg.qk_nope_dim} + {cfg.qk_rope_dim} and v width {cfg.v_head_dim}")
    return f"head_dim {cfg.head_dim}"


def zoo_chimera(name, n_layers, **replace):
    """The registry's config of ``name`` (its Chimera default: m 128, L 256,
    n_global 32, d_head 128), cut to ``n_layers`` of its layers."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), n_layers=n_layers, **replace)


def drop_free(cfg):
    """``cfg`` with a capacity factor at which no MoE group drops a
    selection: top-k picks k distinct experts, so an expert takes at most one
    selection per token of its group, and a factor of ceil(E / k) gives it
    room for the whole group (C = int(g k cf / E) >= g).  Prefill and
    one-token decode then route alike; at the config's 1.25 a prefill drops
    selections that decode does not (ROADMAP Queue 3)."""
    import dataclasses

    if not cfg.moe_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=float(-(-cfg.moe_experts // cfg.moe_top_k)))


class plain_chimera_kernels:
    """Within the block, the two Chimera kernels' wrappers run their plain
    versions on the card (chimera_attention one (batch x kv-head) row at a
    time: its dense (Gq, T, T) scores are 1 GB a row at T 8192, and with
    ``prefill`` "plain" its backward too, chimera_attention_bwd_plain a row
    at a time), with the wrappers' own casts.  Or part by part: ``prefill``
    (chimera_attention) is "plain", "kernel", "kernel local" (the local
    tier's partials from the kernel, the stream tier's from the plain
    version) or "kernel stream" (the other way round); ``decode``
    (decode_step) is "plain" or "kernel"."""

    def __init__(self, prefill="plain", decode="plain"):
        self.prefill, self.decode = prefill, decode

    def __enter__(self):
        import torch
        from repro_torch.kernels.chimera_attention import ops as cops
        from repro_torch.kernels.decode_step import ops as dops

        self.saved = kernel_attention, kernel_decode, kernel_bwd = (
            cops.chimera_attention_bh, dops.decode_step, cops.chimera_attention_bwd_bh)

        def plain_attention(q, k, v, phi_q, phi_k, *, chunk_size, use_local=True,
                            use_stream=True):
            dtype = q.dtype
            for t in (k, v, phi_q, phi_k):
                dtype = torch.promote_types(dtype, t.dtype)
            rows = [cops.chimera_attention_partials_plain(
                *(x[i:i + 1, None].float() for x in (q, k, v, phi_q, phi_k)),
                chunk_size, use_local, use_stream) for i in range(q.shape[0])]
            return (torch.cat([n[:, 0] for n, _ in rows]).to(dtype),
                    torch.cat([d[:, 0] for _, d in rows]).to(dtype))

        def plain_bwd(*xs, chunk_size, use_local=True, use_stream=True):
            rows = [cops.chimera_attention_bwd_plain(
                *(x[i:i + 1, None].float() for x in xs), chunk_size, use_local, use_stream)
                for i in range(xs[0].shape[0])]
            return tuple(torch.cat([r[j][:, 0] for r in rows]) for j in range(5))

        def mixed_attention(*a, chunk_size, use_local=True, use_stream=True):
            local, stream = ((kernel_attention, plain_attention)
                             if self.prefill == "kernel local" else
                             (plain_attention, kernel_attention))
            n1, d1 = local(*a, chunk_size=chunk_size, use_local=use_local, use_stream=False)
            n2, d2 = stream(*a, chunk_size=chunk_size, use_local=False, use_stream=use_stream)
            return n1 + n2, d1 + d2

        def plain_decode(q, k_t, v_t, phi_q, phi_buf, k_buf, v_buf, S, Z, count, *, chunk_size,
                         gamma=1e-6, gnum=None, gden=None):
            f = [None if t is None else t.float() for t in (q, k_t, v_t, phi_q, phi_buf, gnum,
                                                            gden)]
            return dops.decode_step_plain(*f[:5], k_buf, v_buf, S, Z, count,
                                          chunk_size=chunk_size, gamma=gamma, gnum=f[5],
                                          gden=f[6])

        cops.chimera_attention_bh = {"plain": plain_attention, "kernel": kernel_attention}.get(
            self.prefill, mixed_attention)
        dops.decode_step = plain_decode if self.decode == "plain" else kernel_decode
        cops.chimera_attention_bwd_bh = plain_bwd if self.prefill == "plain" else kernel_bwd
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.chimera_attention import ops as cops
        from repro_torch.kernels.decode_step import ops as dops

        cops.chimera_attention_bh, dops.decode_step, cops.chimera_attention_bwd_bh = self.saved


def lm_replay(cfg, params, prompts, pre, gens, max_len, sequential=False):
    """The engine's path outside the engine, keeping every step's logits:
    the prompts' first ``pre`` tokens through ``prefill_with_caches`` (or,
    ``sequential``, through ``decode_step`` token by token) into float32
    caches, then ``decode_step`` on token ``pre`` and on the generations
    ``gens`` (B, n) teacher-forced.  Returns (B, n, vocab) float32 logits."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.engine import _cache_leaves

    B = prompts.shape[0]
    dev = next(iter(params["embed"].values())).device
    caches = M.init_caches(cfg, B, max_len, dtype=torch.float32, device=dev)
    tokens = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        if sequential:
            for t in range(pre):
                M.decode_step(cfg, params, tokens[:, t],
                              torch.full((B,), t, dtype=torch.int32, device=dev), caches)
        else:
            _, pc = M.prefill_with_caches(cfg, params, tokens[:, :pre], max_len=max_len)
            for dst, src in zip(_cache_leaves(caches), _cache_leaves(pc)):
                dst.copy_(src)
            del pc
        feed = [tokens[:, pre]] + [torch.from_numpy(gens[:, i]).to(dev)
                                   for i in range(gens.shape[1] - 1)]
        out = []
        for i, tok in enumerate(feed):
            lg = M.decode_step(cfg, params, tok,
                               torch.full((B,), pre + i, dtype=torch.int32, device=dev), caches)
            out.append(lg[:, :cfg.vocab_size].float().cpu())
    return torch.stack(out, dim=1)


# the MoE's top-k choice of a token is a near tie where its k-th and
# (k+1)-th router probabilities lie within ROUTE_MARGIN: another fp32
# summation order in attention flips such a choice through the bf16
# residual stream.  route_gaps on an H100 at Mixtral (top-2 of 8): over 4
# prompt seeds, with the long-chunk kernel, its previous version and the
# plain versions, 0 to 6 of the ragged check's 5,152 choices differ
# between prefill and decode, at gaps up to 8.6e-4 (at seed 0, the
# check's, up to 2.1e-4); a planted relative error of 1e-3 in the
# prefill's attention partials flips choices at gaps up to 2.0e-3 to
# 8.4e-3 at every seed, one of 1e-4 up to 5.5e-3 to 6.1e-3 at two seeds of
# the four (seed 0 among them).  At moonshot-v1-16b-a3b (top-6 of 64) the
# check's seed 0 differs at gaps up to 2.66e-4, plain or kernels.  Seed 1
# differed at 1.802e-3 with the long-chunk kernel's local tier on a
# truncating TF32 split (route_flip_cause: its num/den 3.3-7.4x the fp32
# plain version's error from float64); with split_rn there every seed's
# widest flip is 2.80e-4 (plain versions 2.71e-4), and a planted 1e-3
# error still flips choices at 1.80e-3 to 2.59e-3 at every seed (PERF.md
# section 6, ROADMAP Queue 3)
ROUTE_MARGIN = 1e-3


def lm_replay_shared_routes(cfg, params, prompts, pre, gens, max_len, margin=ROUTE_MARGIN):
    """lm_replay of the prompts' prefill, then of the same tokens decoded
    one at a time, the second run taking the first run's MoE experts for a
    token wherever its own choice differs at a near tie (top-2 gap <=
    ``margin``, in either run); a choice that differs beyond the margin
    fails.  So the two runs are compared on the same discrete routing, and
    every routing decision is held to the margin.  Returns (fast, seq, the
    forced ties as (MoE layer, slot, position, gap)); the MoE layers are
    the layers with a MoE MLP (all of them but in Jamba)."""
    import torch
    from repro_torch.models import moe

    n_layers = cfg.n_groups * sum("_moe" in params["blocks"][f"b{j}"]
                                  for j in range(len(cfg.pattern)))
    real, B = moe._top_k, prompts.shape[0]
    calls = []

    def record(probs, k):
        vals, ids = real(probs, k)
        calls.append((probs, ids))
        return vals, ids

    def gap(p, k):
        top = torch.topk(p, k + 1, dim=-1).values
        return top[..., k - 1] - top[..., k]

    forced, count = [], [0]

    def replay(probs, k):
        vals, ids = real(probs, k)
        step, layer = divmod(count[0], n_layers)
        count[0] += 1
        if step < pre:  # a prompt token: the prefill's call of this layer, at this position
            pf, idf = (x.reshape(B, pre, -1)[:, step] for x in calls[layer])
        else:  # a fed token: both runs decode it
            pf, idf = (x.reshape(B, -1) for x in calls[n_layers * (1 + step - pre) + layer])
        own, p = ids.reshape(B, -1), probs.reshape(B, -1)
        same = (own.sort(-1).values == idf.sort(-1).values).all(-1)
        if bool(same.all()):
            return vals, ids
        g = torch.maximum(gap(p, k), gap(pf, k))
        for slot in (~same).nonzero().flatten().tolist():
            if float(g[slot]) > margin:
                fail(f"lm-chimera: layer {layer} slot {slot} position {step} routes to experts "
                     f"{own[slot].tolist()} in decode and {idf[slot].tolist()} in the prefill "
                     f"with a top-2 probability gap of {float(g[slot]):.3e} > {margin:g}")
            forced.append((layer, slot, step, float(g[slot])))
        ids = torch.where(same[:, None], own, idf).reshape(ids.shape)
        return torch.gather(probs, -1, ids), ids

    try:
        moe._top_k = record
        fast = lm_replay(cfg, params, prompts, pre, gens, max_len)
        moe._top_k = replay
        seq = lm_replay(cfg, params, prompts, pre, gens, max_len, sequential=True)
    finally:
        moe._top_k = real
    return fast, seq, forced


class planted_attention_error:
    """Within the block, chimera_attention's partials (the prefill's) come
    back with a planted relative error: num and den each times (1 + eps u),
    u uniform in [-1, 1], drawn apart on the card from ``seed``."""

    def __init__(self, eps, seed):
        self.eps, self.seed = eps, seed

    def __enter__(self):
        import torch
        from repro_torch.kernels.chimera_attention import ops as cops

        self.saved = real = cops.chimera_attention_bh
        g = torch.Generator(device="cuda").manual_seed(self.seed)

        def attention(*a, **k):
            num, den = real(*a, **k)
            return tuple(x * (1 + self.eps * (2 * torch.rand(x.shape, generator=g, device=x.device,
                                                            dtype=x.dtype) - 1))
                         for x in (num, den))

        cops.chimera_attention_bh = attention
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.chimera_attention import ops as cops

        cops.chimera_attention_bh = self.saved


def route_gaps(n_seeds=4, others=None, planted=(1e-3, 1e-4), name="mixtral-8x7b"):
    """Readings for ROUTE_MARGIN, not part of the smoke run: phase
    lm-chimera (c)'s ragged prefill-vs-decode replay of the MoE config
    ``name`` (the same weights, drop-free) for ``n_seeds`` prompt seeds,
    with this tree's kernels, with each tree's of ``others`` ({label: csrc
    directory}, built by build_other_library), with the plain versions, and
    with this tree's kernels under a planted_attention_error of each eps in
    ``planted``.  Every routing choice that differs between the two runs is
    kept with its top-k gap, whatever the gap.  Logs, per run, their count and gaps, and
    returns {label: [every gap over the seeds]}."""
    from repro_torch.kernels import _build

    cfg, dcfg, params = route_model(name)
    libs = {"this": _build.load_library()}
    libs.update({label: build_other_library(d) for label, d in (others or {}).items()})
    runs = [(label, label, None) for label in libs] + [("plain", "this", "plain")] + [
        (f"planted {eps:g}", "this", eps) for eps in planted]
    gaps = {label: [] for label, _, _ in runs}
    pre = RAGGED_T - 1
    for i in range(n_seeds):
        prompts, gens = route_prompts(cfg, dcfg, params, i)
        for label, lib, how in runs:
            _build._lib = libs[lib]
            try:
                ctx = (plain_chimera_kernels() if how == "plain" else
                       contextlib.nullcontext() if how is None else
                       planted_attention_error(how, SEED + 70 + i))
                with ctx:
                    fast, seq, ties = lm_replay_shared_routes(dcfg, params, prompts, pre, gens,
                                                              SERVE_MAX_LEN, margin=math.inf)
            finally:
                _build._lib = libs["this"]
            err = float((fast - seq).abs().max())
            g = sorted((t[3] for t in ties), reverse=True)
            gaps[label] += g
            log("route-gaps", f"{name} seed {i} {label}: {len(g)} of "
                              f"{SERVE_SLOTS * (pre + RAGGED_NEW) * cfg.n_layers} choices differ; "
                              f"(layer, slot, position, gap) {fmt_ties(ties)}; logits max abs "
                              f"diff {err:.3e}")
            del fast, seq
    for label, g in gaps.items():
        log("route-gaps", f"{name} {label}: {len(g)} differing choices over {n_seeds} seeds, "
                          f"largest gap {max(g) if g else 0.0:.3e}")
    return gaps


def route_model(name):
    """The MoE config ``name`` at SERVE_LAYERS layers as route_gaps serves
    it: (config, its drop-free copy, seed-0 weights built by the launcher)."""
    import torch
    from repro_torch.launch import serve as LS
    from repro_torch.train import classifier as C

    cfg = zoo_chimera(name, SERVE_LAYERS)
    ccfg = C.ClassifierConfig(arch=cfg, n_classes=2, marker_base=cfg.vocab_size)
    params = C.init_classifier(ccfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    args = LS.parse_args(["--arch", cfg.name, "--requests", str(SERVE_SLOTS), "--slots",
                          str(SERVE_SLOTS), "--prompt-len", str(RAGGED_T), "--max-new",
                          str(RAGGED_NEW), "--max-len", str(SERVE_MAX_LEN), "--prefill",
                          "--waive", "resource-ledger"])
    return cfg, drop_free(cfg), LS.build(args, params=params, arch=cfg).engine.params


def route_prompts(cfg, dcfg, params, i):
    """Prompt seed ``i`` of the ragged check (seed 0 is the check's) and the
    tokens the engine generates for it: (prompts, gens)."""
    from repro_torch.serve.engine import Request, ServeEngine

    prompts = np.random.default_rng(SEED + 60 + i).integers(0, cfg.vocab_size,
                                                            (SERVE_SLOTS, RAGGED_T))
    eng = ServeEngine(dcfg, params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      device="cuda")
    reqs = [Request(rid=j, prompt=p.tolist(), max_new_tokens=RAGGED_NEW)
            for j, p in enumerate(prompts)]
    eng.prefill_batch(reqs)
    eng.run_until_done()
    return prompts, np.array([r.generated for r in reqs])


def fmt_ties(ties, n=6):
    """The ``n`` widest of lm_replay_shared_routes' forced ties."""
    return [(a, b, c, f"{g:.3e}") for a, b, c, g in sorted(ties, key=lambda t: -t[3])[:n]]


# the parts that route_flip_cause swaps between kernel and plain version:
# (prefill attention, decode_step), as plain_chimera_kernels takes them
FLIP_RUNS = (("kernel", "kernel"), ("plain", "plain"), ("kernel", "plain"), ("plain", "kernel"),
             ("kernel local", "kernel"), ("kernel stream", "kernel"))


def route_flip_cause(i=1, name="moonshot-v1-16b-a3b", repeats=2):
    """Where a routing flip of route_gaps comes from, not part of the smoke
    run: prompt seed ``i`` of the ragged check at ``name``, replayed
    (prefill against token-by-token decode, every differing choice kept)
    ``repeats`` times with the kernels, then with each part of FLIP_RUNS
    taken from the kernel or the plain version; then every prefill
    attention call of a kernel run and every decode_step call at the
    widest flip's position, on their recorded inputs, by the kernel and by
    the fp32 plain version against the plain version in float64, tier by
    tier.  Logs it all and returns {run: ties}."""
    import torch
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops

    cfg, dcfg, params = route_model(name)
    prompts, gens = route_prompts(cfg, dcfg, params, i)
    pre, found = RAGGED_T - 1, {}
    for r, (prefill, decode) in enumerate((FLIP_RUNS[0],) * (repeats - 1) + FLIP_RUNS):
        with plain_chimera_kernels(prefill, decode):
            fast, seq, ties = lm_replay_shared_routes(dcfg, params, prompts, pre, gens,
                                                      SERVE_MAX_LEN, margin=math.inf)
        label = f"prefill {prefill}, decode {decode}" + (f" #{r + 1}" if r < repeats else "")
        found[label] = ties
        log("route-cause", f"{name} seed {i} {label}: {len(ties)} choices differ, (layer, slot, "
                           f"position, gap) {fmt_ties(ties)}; logits max abs diff "
                           f"{float((fast - seq).abs().max()):.3e}")
        del fast, seq
    widest = max(found["prefill kernel, decode kernel #1"], key=lambda t: t[3], default=None)

    # the recorded inputs of the kernels' prefill attention and of decode_step
    # at the widest flip's position, every layer
    att, dec, calls = [], [], [0]
    real_att, real_dec = cops.chimera_attention_bh, dops.decode_step

    def rec_att(*a, **k):
        att.append(([x.detach().clone() for x in a], k))
        return real_att(*a, **k)

    def rec_dec(*a, **k):
        step = calls[0] // cfg.n_layers
        calls[0] += 1
        if widest is not None and step == widest[2]:
            dec.append(([x.detach().clone() for x in a],
                        {n: v.detach().clone() if torch.is_tensor(v) else v
                         for n, v in k.items()}))
        return real_dec(*a, **k)

    try:
        cops.chimera_attention_bh, dops.decode_step = rec_att, rec_dec
        lm_replay(dcfg, params, prompts, pre, gens, SERVE_MAX_LEN)
        cops.chimera_attention_bh = real_att
        lm_replay(dcfg, params, prompts, pre, gens, SERVE_MAX_LEN, sequential=True)
    finally:
        cops.chimera_attention_bh, dops.decode_step = real_att, real_dec

    def errs(got, ref):
        return [f"{float((g.double() - r).abs().max()):.3e}" for g, r in zip(got, ref)]

    def partials(xs, L, mode):  # the plain version, one row at a time, in xs' dtype
        rows = [cops.chimera_attention_partials_plain(*(x[r:r + 1, None] for x in xs), L, *mode)
                for r in range(xs[0].shape[0])]
        return torch.cat([n[:, 0] for n, _ in rows]), torch.cat([d[:, 0] for _, d in rows])

    with torch.no_grad():
        for layer, (a, k) in enumerate(att):
            L = k["chunk_size"]
            for mode in ((True, True), (True, False), (False, True)):
                kern = real_att(*a, chunk_size=L, use_local=mode[0], use_stream=mode[1])
                plain = partials([x.float() for x in a], L, mode)
                exact = partials([x.double() for x in a], L, mode)
                ratio = [(n / (d[..., None] + 1e-6)).double() for n, d in (kern, plain)]
                want = exact[0] / (exact[1][..., None] + 1e-6)
                log("route-cause", f"{name} prefill attention layer {layer} (BH "
                                   f"{a[0].shape[0]}, Gq {a[0].shape[1]}, T {a[0].shape[2]}, "
                                   f"{a[0].dtype}) local={mode[0]} stream={mode[1]} against "
                                   f"float64: kernel num/den {errs(kern, exact)}, fp32 plain "
                                   f"{errs(plain, exact)}; num/den ratio kernel "
                                   f"{float((ratio[0] - want).abs().max()):.3e}, fp32 plain "
                                   f"{float((ratio[1] - want).abs().max()):.3e}")
        for layer, (a, k) in enumerate(dec):
            outs = {}
            for label, dtype in (("kernel", None), ("fp32 plain", torch.float32),
                                 ("float64", torch.float64)):
                x = [t.to(dtype, copy=True) if dtype is not None and t.is_floating_point()
                     else t.clone() for t in a]
                kw = {n: v.to(dtype) if dtype is not None and torch.is_tensor(v) else v
                      for n, v in k.items()}
                fn = real_dec if dtype is None else dops.decode_step_plain
                outs[label] = fn(*x, **kw)[0].double()
            log("route-cause", f"{name} decode_step layer {layer} at position {widest[2]} (BH "
                               f"{a[0].shape[0]}, Gq {a[0].shape[1]}) against float64: kernel "
                               f"{float((outs['kernel'] - outs['float64']).abs().max()):.3e}, "
                               f"fp32 plain "
                               f"{float((outs['fp32 plain'] - outs['float64']).abs().max()):.3e}")
    return found


def hold_generations(what, gens, logits, margin):
    """Each greedy token equals the reference logits' argmax wherever their
    top-2 margin exceeds ``margin``; returns (held, total, smallest margin)."""
    import torch

    top = torch.topk(logits, 2, dim=-1)
    gaps = top.values[..., 0] - top.values[..., 1]
    sure = gaps > margin
    wrong = sure & (top.indices[..., 0] != torch.from_numpy(gens))
    if wrong.any():
        fail(f"{what}: {int(wrong.sum())} greedy tokens differ where the reference's top-2 "
             f"margin exceeds {margin:g}")
    return int(sure.sum()), sure.numel(), float(gaps.min())


def phase_lm_chimera(recs):
    """The zoo's Chimera configs served on the card.  (a) decode_step and
    chimera_attention at the zoo's widths against their plain versions,
    timed; then, for each config of ZOO_LM (``lm_serve_full_width``), (b)
    the main path: ``launch/serve.py``'s build and serve at full width, 2
    layers, 4 slots x 8193-token prompts through prefill_batch (T 8192 = 32
    chunks of 256 through chimera_attention) and 16 new tokens each
    (decode_step at L 256); (c) that prefill and decode held against the
    plain versions on the card, and a ragged 641-token prompt's prefill
    against token-by-token decode; then (d) the smoke configs of SMOKE_LM,
    card against CPU, and the baseline linear attention card against CPU."""
    import torch

    # (a) the kernels at the zoo's widths
    wide = check_decode_wide()
    check_chimera_long_edges()
    long = check_chimera_long(timed=True)
    wide["spread"]["shape"] = "BH 32 Gq 4 d=dv=m 128 L 256, tiled ring"
    for name, r in (("decode_step", wide["spread"]), ("chimera_attention", long)):
        other_shape(recs, name, r)

    # (b), (c) each config's main path, its launches counted apart
    zoo = {name: lm_serve_full_width(name) for name in ZOO_LM}
    launches = {k: sum(z["launches"][k] for z in zoo.values()) for k in zoo[ZOO_LM[0]]["launches"]}
    torch.cuda.empty_cache()

    # (d) the smoke sizes, card against CPU
    for name in SMOKE_LM:
        lm_smoke_card_vs_cpu(name)
    for name in SOFTMAX_LM:
        lm_smoke_card_vs_cpu(name, use_chimera=False)
    check_linear_attention()
    return {"launches": launches, "zoo": zoo}


def lm_serve_full_width(name):
    """One config of ZOO_LM at full width, 2 layers: (b) the launcher's
    build and serve, its launches counted from 0 just before and read just
    after; one profiled prefill and decode step; (c) against the plain
    versions on the card, and a ragged prompt's prefill against
    token-by-token decode (drop-free, the MoE's near ties routed alike)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as LS
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    # (b) the main path through the launcher
    cfg = zoo_chimera(name, SERVE_LAYERS)
    dep, nbytes, draw_s = launcher(cfg)
    ch = cfg.chimera
    mlp = (f"{cfg.moe_experts} experts of d_ff {cfg.moe_d_ff or cfg.d_ff} top-{cfg.moe_top_k}"
           f" + {cfg.moe_shared_experts} shared" if cfg.moe_experts else f"dense d_ff {cfg.d_ff}")
    log("lm-chimera", f"{cfg.name} (Chimera), {cfg.n_layers} of {get_config(name).n_layers} "
                      f"layers at full width (d {cfg.d_model}, {cfg.n_heads} heads / "
                      f"{cfg.n_kv_heads} kv-heads, {attn_label(cfg)}, qk-norm "
                      f"{cfg.qk_norm}, m {ch.feature_map.m}, L {ch.chunk_size}, n_global "
                      f"{ch.n_global}, {mlp}, vocab {cfg.vocab_size}, dtype {cfg.dtype}): "
                      f"{nbytes // 4} fp32 parameters drawn on the card in {draw_s:.2f} s")
    engine = dep.engine
    # warm-up at the main path's shapes (cuBLAS picks its kernels on a first call)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (SERVE_SLOTS, SERVE_T + 1))
    warm = lm_replay(cfg, engine.params, prompts, SERVE_T, np.zeros((SERVE_SLOTS, 1), np.int64),
                     SERVE_MAX_LEN)
    if not torch.isfinite(warm).all():
        fail(f"lm-chimera {name}: non-finite logits after the warm-up prefill")
    res, launches, peak = serve_counted(dep, lambda ticks: {
        "chimera_attention": cfg.n_layers, "decode_step": cfg.n_layers * ticks}, "lm-chimera")
    decode_s = res.seconds - res.prefill_seconds
    gens = np.array([r.generated for r in res.requests])
    if [r.prompt for r in res.requests] != prompts.tolist():
        fail(f"lm-chimera {name}: the launcher's prompts are not the replays' prompts")
    n_prefill = SERVE_SLOTS * SERVE_T
    log("lm-chimera", LS.summary(dep, res))
    log("lm-chimera", f"prefill_batch {SERVE_SLOTS} x {SERVE_T} tokens: "
                      f"{res.prefill_seconds * 1e3:.1f} ms, {n_prefill / res.prefill_seconds:.0f} "
                      f"tokens/s; decode: {res.ticks} ticks ({SERVE_SLOTS} slots) in "
                      f"{decode_s * 1e3:.1f} ms: {decode_s / res.ticks * 1e3:.2f} ms per tick")
    log("lm-chimera", f"launches in the main-path run: {launches} (chimera_attention = "
                      f"{cfg.n_layers} layers x 1 prefill of 32 chunks; decode_step = "
                      f"{cfg.n_layers} layers x {res.ticks} ticks); max_memory_allocated "
                      f"{peak} B")
    log("lm-chimera", "greedy generations (first 8 ids): "
                      + "; ".join(f"{r.rid}: {r.generated[:8]}" for r in res.requests))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tokens = torch.from_numpy(prompts[:, :SERVE_T]).to("cuda")
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        M.prefill_with_caches(cfg, engine.params, tokens, max_len=SERVE_MAX_LEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, rows = report_profile(prof, wall, f"one {name} prefill of {SERVE_SLOTS} x {SERVE_T} "
                                         "tokens")
    long_ms = sum(ms for key, (ms, _) in rows.items() if any(x in key for x in LONG_KERNELS))
    kv, Gq, d, dv = attn_widths(cfg)
    nbytes, flops = chimera_cost(SERVE_SLOTS, kv, Gq, SERVE_T, d, dv, ch.feature_map.m,
                                 ch.chunk_size)
    bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
    log("lm-chimera", f"{name}: the long-chunk kernel's three launches per layer take "
                      f"{long_ms:.2f} ms of that prefill's device time ({cfg.n_layers} layers, "
                      f"BH {SERVE_SLOTS * kv}, Gq {Gq}, d {d}, dv {dv}); bound {bound_ms:.4f} ms a "
                      f"layer by {bound_by} ({nbytes} B, {flops} flop x{TF32_PASSES} in TF32)")
    tok = torch.from_numpy(gens[:, -1]).to("cuda")
    pos = torch.full((SERVE_SLOTS,), SERVE_T + SERVE_NEW, dtype=torch.int32, device="cuda")
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        M.decode_step(cfg, engine.params, tok, pos, engine.caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, f"one {name} decode_step of {SERVE_SLOTS} slots (no engine "
                               "bookkeeping)")
    del tokens

    # (c) against the plain versions on the card, and prefill against decode
    got = lm_replay(cfg, engine.params, prompts, SERVE_T, gens, SERVE_MAX_LEN)
    with plain_chimera_kernels():
        ref = lm_replay(cfg, engine.params, prompts, SERVE_T, gens, SERVE_MAX_LEN)
    err = compare(f"lm-chimera {name} logits, kernels vs plain versions", got, ref,
                  atol=LM_LOGIT_TOL, rtol=LM_LOGIT_TOL)
    held, total, gap = hold_generations(f"lm-chimera {name} kernels vs plain", gens, ref,
                                        LM_MARGIN)
    log("lm-chimera", f"prefill + {SERVE_NEW} decode steps, kernels against the plain versions "
                      f"on the card: logits max abs diff {err:.3e} (tolerance {LM_LOGIT_TOL:g} + "
                      f"{LM_LOGIT_TOL:g}*|ref|); greedy tokens equal at {held} of {total} "
                      f"positions whose top-2 margin exceeds {LM_MARGIN:g} (smallest margin "
                      f"{gap:.3e})")
    # prefill equals token-by-token decode where the MoE drops no token: at
    # capacity factor 1.25 a prefill of 4 x 640 tokens drops some, in both
    # packages (the JAX package holds its prefill to decode on drop-free
    # smoke configs), and one-token decode drops none.  So this part serves
    # the same weights drop-free, and routes a near tie of the router in
    # both runs alike (lm_replay_shared_routes); attention, the path under
    # test, is unchanged.
    dcfg = drop_free(cfg)
    rengine = ServeEngine(dcfg, engine.params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                          device="cuda")
    rprompts = np.random.default_rng(SEED + 60).integers(0, cfg.vocab_size,
                                                         (SERVE_SLOTS, RAGGED_T))
    reqs = [Request(rid=i, prompt=p.tolist(), max_new_tokens=RAGGED_NEW)
            for i, p in enumerate(rprompts)]
    rengine.prefill_batch(reqs)
    rengine.run_until_done()
    rgens = np.array([r.generated for r in reqs])
    pre = RAGGED_T - 1
    t0 = time.perf_counter()
    fast, seq, ties = lm_replay_shared_routes(dcfg, engine.params, rprompts, pre, rgens,
                                              SERVE_MAX_LEN)
    seq_s = time.perf_counter() - t0
    err = compare(f"lm-chimera {name} ragged prefill vs token-by-token decode", fast, seq,
                  atol=LM_LOGIT_TOL, rtol=LM_LOGIT_TOL)
    held, total, gap = hold_generations(f"lm-chimera {name} ragged prefill_batch vs "
                                        "token-by-token", rgens, seq, LM_MARGIN)
    routing = (f"capacity factor {dcfg.capacity_factor:g} (drop-free); the MoE's near ties "
               f"(top-k gap <= {ROUTE_MARGIN:g}) routed as in the prefill: {len(ties)} of "
               f"{SERVE_SLOTS * (pre + RAGGED_NEW) * cfg.n_layers} choices, (layer, slot, "
               f"position, gap) {ties}" if cfg.moe_experts else "dense MLP")
    log("lm-chimera", f"{name}: ragged prompt of {RAGGED_T} tokens ({pre // ch.chunk_size} "
                      f"chunks + {pre % ch.chunk_size} in the ring), prefill_batch then "
                      f"{RAGGED_NEW} tokens against token-by-token decode ({pre} steps, "
                      f"{seq_s:.1f} s; {routing}): "
                      f"logits max abs diff {err:.3e} (tolerance {LM_LOGIT_TOL:g} + "
                      f"{LM_LOGIT_TOL:g}*|ref|); greedy tokens equal at {held} of {total} "
                      f"positions whose top-2 margin exceeds {LM_MARGIN:g} (smallest margin "
                      f"{gap:.3e})")
    del dep, engine, rengine, got, ref, fast, seq, warm
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": res.prefill_seconds, "decode_s": decode_s,
            "ticks": res.ticks, "tokens_per_s": n_prefill / res.prefill_seconds,
            "ms_per_tick": decode_s / res.ticks * 1e3, "peak": peak, "long_ms": long_ms,
            "long_bound_ms": bound_ms}


# the baseline linear attention (Eqs. 5-10): card against CPU, fp32 sums of
# up to T products of ~1 taken in other orders (cuBLAS against MKL)
LA_SHAPE = (2, 4, 1024, 64, 64, 128)  # (B, H, T, m, dv, chunk)


def check_linear_attention():
    """``core/linear_attention.py``'s chunked form on the card against the
    CPU on the same inputs (numpy, seeded; phi = elu + 1 of a normal draw),
    and against the recurrent form on the card over its first 256 tokens."""
    import torch
    from repro_torch.core import linear_attention as la

    B, H, T, m, dv, chunk = LA_SHAPE
    rng = np.random.default_rng(SEED + 90)
    elu1 = lambda x: np.where(x > 0, x + 1, np.exp(x)).astype(np.float32)  # noqa: E731
    host = [torch.from_numpy(elu1(rng.standard_normal((B, H, T, m)))) for _ in range(2)]
    host.append(torch.from_numpy(rng.standard_normal((B, H, T, dv)).astype(np.float32)))
    card = [x.cuda() for x in host]
    out_g, (S_g, Z_g) = la.chunked_linear_attention(*card, chunk_size=chunk)
    out_c, (S_c, Z_c) = la.chunked_linear_attention(*host, chunk_size=chunk)
    err = max(compare("linear attention out, card vs CPU", out_g, out_c, atol=ATTN_ATOL),
              compare("linear attention S, card vs CPU", S_g, S_c, atol=ATTN_ATOL),
              compare("linear attention Z, card vs CPU", Z_g, Z_c, atol=ATTN_ATOL))
    n = 256
    rec, _ = la.recurrent_linear_attention(*(x[:, :, :n] for x in card))
    err_r = compare("linear attention chunked vs recurrent on the card", out_g[:, :, :n], rec,
                    atol=ATTN_ATOL)
    log("lm-chimera", f"chunked_linear_attention B={B} H={H} T={T} m={m} dv={dv} chunk={chunk}: "
                      f"card against CPU max abs err {err:.3e}, against the recurrent form on "
                      f"the card (first {n} tokens) {err_r:.3e} (tolerance {ATTN_ATOL:g} + "
                      f"{RTOL:g}*|ref|)")


def lm_smoke_card_vs_cpu(name, use_chimera=True, phase="lm-chimera"):
    """``smoke_config(name)`` (fp32, L 16), or its softmax variant
    (``use_chimera`` False; None keeps the config's), through the launcher's
    engine on the card and on the CPU: prefill_batch of ragged prompts, 6
    greedy tokens each; generations identical and the prefill's next-token
    logits within REF_LOGIT_TOL.  A stack with attention launches its
    kernels on the card; one without (xLSTM) launches none."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.window_attention import ops as wops
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = smoke_config(name)
    if use_chimera is not None:
        cfg = dataclasses.replace(cfg, use_chimera=use_chimera)
    params = M.init_model(cfg, torch.Generator().manual_seed(SEED + 61), device="cpu")
    rng = np.random.default_rng(SEED + 62)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 37, 45)]
    runs = {}
    for dev in ("cuda", "cpu"):
        before = cops.launches + dops.launches + wops.launches
        p = tree_map(lambda t: t.to(dev), params)
        engine = ServeEngine(cfg, p, batch_slots=4, max_len=64, device=dev)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
        engine.prefill_batch(reqs)
        engine.run_until_done()
        with torch.no_grad():
            logits, _ = M.prefill_with_caches(
                cfg, p, torch.tensor([pr[:36] for pr in prompts], device=dev), max_len=64)
        if (cops.launches + dops.launches + wops.launches > before) != (
                dev == "cuda" and "attn" in cfg.pattern):
            fail(f"{phase} smoke {name}: kernel launches on {dev}")
        runs[dev] = ([r.generated for r in reqs], logits.cpu())
    (gen_g, lg), (gen_c, lc) = runs["cuda"], runs["cpu"]
    if gen_g != gen_c:
        fail(f"{phase} smoke {name}: greedy generations differ: card {gen_g} vs CPU {gen_c}")
    err = compare(f"{phase} smoke {name} logits", lg, lc, atol=REF_LOGIT_TOL,
                  rtol=REF_LOGIT_TOL)
    mode = ("no attention" if "attn" not in cfg.pattern else "Chimera (m 16, L 16)"
            if cfg.use_chimera else "full-causal softmax")
    mode += "".join(f", {kind}" for kind in dict.fromkeys(cfg.pattern) if kind != "attn")
    log(phase, f"{name} smoke ({mode}, d_head {cfg.head_dim}): prefill_batch of "
               f"{[len(p) for p in prompts]} tokens + 6 greedy tokens, card and CPU "
               f"generations identical; next-token logits after 36 tokens max abs diff "
               f"{err:.3e} (tolerance {REF_LOGIT_TOL:g} + {REF_LOGIT_TOL:g}*|ref|)")


# --------------------------------------------------------------------------
# 13. lm-mla (MiniCPM3-4B's MLA and full-causal softmax attention)
# --------------------------------------------------------------------------

MLA_LM = "minicpm3-4b"
# lm-mla (b)'s deeper run: 4 of MiniCPM3-4B's 62 layers, a depth cut
# (PERF.md section 4); lm_serve_deeper(MLA_LM) runs all 62
MLA_DEPTH = 4


def other_shape(recs, name, r):
    """``r``'s numbers as one more shape of kernel ``name`` in the kernels
    line; returns that entry."""
    keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    recs[name].setdefault("other_shapes", []).append({k: r.get(k) for k in keys})
    return recs[name]["other_shapes"][-1]


def check_lm_mla_kernels(recs):
    """(a) decode_step and the long-chunk kernel at MLA's Chimera widths
    (4 slots x 40 heads, Gq 1, d 96, dv 64, m 128, L 256; decode_step under
    every fill pattern, with and without the globals), the short-chunk
    kernel and decode_step at MLA's smoke widths (d 24, dv 16, m 16, L 16),
    and window_attention at W = T = 8192 for each softmax variant of
    SOFTMAX_LM, against their plain versions, timed against their bounds.
    Returns each timed shape's entry of the kernels line, by kernel (the
    window's by config)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_step import ops as dops

    cfg = get_config(MLA_LM)
    kv, Gq, d, dv = attn_widths(cfg)
    m, L = cfg.chimera.feature_map.m, cfg.chimera.chunk_size
    entries = {}
    for fill in ZOO_FILLS:
        for with_global in (False, True):
            timed = with_global and fill == "spread"
            r = check_decode(with_global, timed, fill=fill, B=SERVE_SLOTS, Gq=Gq, d=d, dv=dv,
                             m=m, L=L, heads=kv)
            if timed:
                r["shape"] = (f"BH {SERVE_SLOTS * kv} Gq {Gq} d {d} dv {dv} m {m} L {L}, "
                              f"{dops.layout(Gq, d, dv, m, L)[0]} ring")
                entries["decode_step"] = other_shape(recs, "decode_step", r)
    for fill in DECODE_FILLS:
        for with_global in (False, True):
            check_decode(with_global, False, fill=fill, B=64, Gq=1, d=24, dv=16, m=16, L=16)
    worst = max(check_chimera_edge(16, T, *mode, m=16, d=24, dv=16)
                for T in (16, 64) for mode in CHIMERA_MODES)
    log("kernels", f"chimera_attention at MLA's smoke widths (L 16, m 16, d 24, dv 16, T = L and "
                   f"4L, every local/stream pair): max abs err {worst:.3e} (tolerance "
                   f"{ATTN_ATOL:g} + {RTOL:g}*|ref|)")
    entries["chimera_attention"] = other_shape(
        recs, "chimera_attention", check_chimera_long(True, shape=(SERVE_SLOTS, kv, Gq, SERVE_T,
                                                                   d, dv)))
    for name in SOFTMAX_LM:
        kv, Gq, d, dv = attn_widths(get_config(name))
        r = check_window(True, shape=(SERVE_SLOTS, kv * Gq, kv, SERVE_T, SERVE_T, d, dv))
        r["shape"] = f"{name} softmax: " + r["shape"]
        entries[name] = other_shape(recs, "window_attention", r)
    return entries


class plain_softmax_attention:
    """Within the block, blockwise_softmax_attention (the full-causal
    softmax prefill) runs its plain version on the card, one slot at a
    time: its kv blocks of ``softmax_blk`` keys form (Hkv, Gq, T, blk)
    fp32 scores, 1.3 GB a slot at MiniCPM3-4B's width."""

    def __enter__(self):
        import torch
        from repro_torch.models import attention as A

        self.saved = A.blockwise_softmax_attention

        def plain(q, k, v, blk=1024, causal=True):
            return torch.cat([A.blockwise_softmax_attention_plain(q[b:b + 1], k[b:b + 1],
                                                                  v[b:b + 1], blk)
                              for b in range(q.shape[0])])

        A.blockwise_softmax_attention = plain
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A

        A.blockwise_softmax_attention = self.saved


def launcher(cfg, prompt_len=SERVE_T + 1, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN):
    """The LM launcher's build for ``cfg`` (served as ``cfg.name``) at full
    width: seed-0 weights drawn on the card, ``slots`` slots x
    ``prompt_len``-token prompts (one request a slot), 16 new tokens,
    ``--prefill``, the resource ledger waived.  Returns (deployment,
    parameter bytes, seconds to draw them)."""
    import torch
    from repro_torch.launch import serve as LS
    from repro_torch.optim.optimizer import tree_flatten
    from repro_torch.train import classifier as C

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ccfg = C.ClassifierConfig(arch=cfg, n_classes=2, marker_base=cfg.vocab_size)
    params = C.init_classifier(ccfg, torch.Generator(device="cuda").manual_seed(SEED),
                               device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in tree_flatten(params)[0])
    args = LS.parse_args(["--arch", cfg.name, "--requests", str(slots), "--slots", str(slots),
                          "--prompt-len", str(prompt_len), "--max-new", str(SERVE_NEW),
                          "--max-len", str(max_len), "--prefill", "--waive",
                          "resource-ledger"])
    return LS.build(args, params=params, arch=cfg), nbytes, draw_s


def serve_counted(dep, want, phase="lm-mla"):
    """``launch/serve.py``'s serve of ``dep`` with every kernel's launch count
    zeroed just before and read just after, those ``want(ticks)`` names held
    to its counts, and the generations to the vocabulary; returns (result,
    launches, peak bytes)."""
    import torch
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.flow_ingest import ops as sops
    from repro_torch.kernels.window_attention import ops as wops
    from repro_torch.launch import serve as LS

    name = dep.args.arch
    torch.cuda.reset_peak_memory_stats()
    wops.launches = cops.launches = dops.launches = sops.launches = 0
    res = LS.serve(dep)
    launches = {"chimera_attention": cops.launches, "decode_step": dops.launches,
                "window_attention": wops.launches, "flow_score": sops.launches}
    peak = torch.cuda.max_memory_allocated()
    for k, n in want(res.ticks).items():
        if launches[k] != n:
            fail(f"{phase} {name}: {k} launched {launches[k]} times, want {n}: {launches}")
    vocab = dep.program.ccfg.arch.vocab_size
    gens = np.array([r.generated for r in res.requests])
    if gens.shape != (dep.args.requests, SERVE_NEW) or gens.min() < 0 or gens.max() >= vocab:
        fail(f"{phase} {name}: generations of shape {gens.shape}, ids {gens.min()}..{gens.max()}")
    return res, launches, peak


def timing_line(res, slots=SERVE_SLOTS, T=SERVE_T):
    n = slots * T
    decode_s = res.seconds - res.prefill_seconds
    return (f"prefill_batch {slots} x {T} tokens: {res.prefill_seconds * 1e3:.1f} ms, "
            f"{n / res.prefill_seconds:.0f} tokens/s; decode: {res.ticks} ticks ({slots} "
            f"slots) in {decode_s * 1e3:.1f} ms: {decode_s / res.ticks * 1e3:.2f} ms per tick")


def lm_serve_deeper(name, n_layers=None):
    """(b) ``name`` at full width and ``n_layers`` of its layers (all of
    them if None) through the launcher (4 slots x 8193-token prompts, 16
    new tokens each), timed, after the 2-layer run of the same widths
    (cuBLAS has picked its kernels); its launches counted; then one
    profiled prefill (logits finite, of the padded vocabulary) and decode
    step for the device's busy share."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    dep, nbytes, draw_s = launcher(cfg)
    log("lm-mla", f"{name} (Chimera) at full width, {cfg.n_layers} of "
                  f"{get_config(name).n_layers} layers: d "
                  f"{cfg.d_model}, {cfg.n_heads} heads, {attn_label(cfg)}, dense d_ff "
                  f"{cfg.d_ff}, vocab {cfg.vocab_size}, dtype {cfg.dtype}: {nbytes // 4} fp32 "
                  f"parameters ({nbytes} B) drawn on the card in {draw_s:.2f} s")
    res, launches, peak = serve_counted(dep, lambda ticks: {
        "chimera_attention": cfg.n_layers, "decode_step": cfg.n_layers * ticks,
        "window_attention": 0})
    decode_s = res.seconds - res.prefill_seconds
    log("lm-mla", f"{name} {cfg.n_layers} layers: {timing_line(res)}; launches {launches}; "
                  f"max_memory_allocated {peak} B")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prompts = np.array([r.prompt for r in res.requests])
    tokens = torch.from_numpy(prompts[:, :SERVE_T]).to("cuda")
    engine = dep.engine
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, _ = M.prefill_with_caches(cfg, engine.params, tokens, max_len=SERVE_MAX_LEN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms, _ = report_profile(prof, wall, f"one {name} prefill of {SERVE_SLOTS} x {SERVE_T} "
                                            f"tokens, {cfg.n_layers} layers")
    if tuple(logits.shape) != (SERVE_SLOTS, cfg.padded_vocab) or not torch.isfinite(logits).all():
        fail(f"lm-mla {name}: prefill logits of shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    del logits
    tok = torch.from_numpy(np.array([r.generated[-1] for r in res.requests])).to("cuda")
    pos = torch.full((SERVE_SLOTS,), SERVE_T + SERVE_NEW, dtype=torch.int32, device="cuda")
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        M.decode_step(cfg, engine.params, tok, pos, engine.caches)
        torch.cuda.synchronize()
        tick_wall = time.perf_counter() - t0
    tick_busy_ms, _ = report_profile(prof, tick_wall, f"one {name} decode_step of {SERVE_SLOTS} "
                                                      f"slots, {cfg.n_layers} layers")
    del dep, engine, tokens
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": res.prefill_seconds, "ticks": res.ticks,
            "tokens_per_s": SERVE_SLOTS * SERVE_T / res.prefill_seconds,
            "ms_per_tick": decode_s / res.ticks * 1e3, "peak": peak,
            "busy": busy_ms and busy_ms / (wall * 1e3),
            "tick_busy": tick_busy_ms and tick_busy_ms / (tick_wall * 1e3)}


def lm_softmax_full_width(name):
    """(c) the full-causal softmax variant of ``name`` (``--no-chimera``) at
    full width, 2 layers, through the launcher: 4 slots x 8193-token prompts
    (the prefill through window_attention at W = T = 8192) and 16 new
    tokens; that prefill and decode against the plain version on the card,
    and a ragged 641-token prompt's prefill_batch against token-by-token
    decode."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config(name), use_chimera=False, n_layers=SERVE_LAYERS)
    dep, nbytes, draw_s = launcher(cfg)
    engine = dep.engine
    kv, Gq, d, dv = attn_widths(cfg)
    log("lm-mla", f"{name} softmax (full-causal), {cfg.n_layers} of {get_config(name).n_layers} "
                  f"layers at full width (d {cfg.d_model}, {cfg.n_heads} heads / {kv} kv-heads, "
                  f"{attn_label(cfg)}, vocab {cfg.vocab_size}, dtype {cfg.dtype}): {nbytes // 4} "
                  f"fp32 parameters drawn on the card in {draw_s:.2f} s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (SERVE_SLOTS, SERVE_T + 1))
    warm = lm_replay(cfg, engine.params, prompts, SERVE_T, np.zeros((SERVE_SLOTS, 1), np.int64),
                     SERVE_MAX_LEN)
    if not torch.isfinite(warm).all():
        fail(f"lm-mla {name} softmax: non-finite logits after the warm-up prefill")
    res, launches, peak = serve_counted(dep, lambda ticks: {
        "window_attention": cfg.n_layers, "chimera_attention": 0, "decode_step": 0})
    if [r.prompt for r in res.requests] != prompts.tolist():
        fail(f"lm-mla {name}: the launcher's prompts are not the replays' prompts")
    log("lm-mla", f"{name} softmax: {timing_line(res)}; launches {launches} (window_attention "
                  f"= {cfg.n_layers} layers x 1 prefill at W = T {SERVE_T}, d {d}, dv {dv}); "
                  f"max_memory_allocated {peak} B")
    gens = np.array([r.generated for r in res.requests])
    got = lm_replay(cfg, engine.params, prompts, SERVE_T, gens, SERVE_MAX_LEN)
    with plain_softmax_attention():
        ref = lm_replay(cfg, engine.params, prompts, SERVE_T, gens, SERVE_MAX_LEN)
    err = compare(f"lm-mla {name} softmax logits, kernel vs plain version", got, ref,
                  atol=LM_LOGIT_TOL, rtol=LM_LOGIT_TOL)
    held, total, gap = hold_generations(f"lm-mla {name} softmax kernel vs plain", gens, ref,
                                        LM_MARGIN)
    log("lm-mla", f"{name} softmax: prefill + {SERVE_NEW} decode steps, window_attention "
                  f"against blockwise_softmax_attention_plain on the card: logits max abs diff "
                  f"{err:.3e} (tolerance {LM_LOGIT_TOL:g} + {LM_LOGIT_TOL:g}*|ref|); greedy tokens "
                  f"equal at {held} of {total} positions whose top-2 margin exceeds {LM_MARGIN:g} "
                  f"(smallest margin {gap:.3e})")
    softmax_logits_fp32(cfg, engine.params, prompts, gens)
    rprompts = np.random.default_rng(SEED + 60).integers(0, cfg.vocab_size,
                                                         (SERVE_SLOTS, RAGGED_T))
    rengine = ServeEngine(cfg, engine.params, batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                          device="cuda")
    reqs = [Request(rid=i, prompt=p.tolist(), max_new_tokens=RAGGED_NEW)
            for i, p in enumerate(rprompts)]
    rengine.prefill_batch(reqs)
    rengine.run_until_done()
    rgens = np.array([r.generated for r in reqs])
    pre = RAGGED_T - 1
    t0 = time.perf_counter()
    fast = lm_replay(cfg, engine.params, rprompts, pre, rgens, SERVE_MAX_LEN)
    seq = lm_replay(cfg, engine.params, rprompts, pre, rgens, SERVE_MAX_LEN, sequential=True)
    seq_s = time.perf_counter() - t0
    err = compare(f"lm-mla {name} softmax ragged prefill vs token-by-token decode", fast, seq,
                  atol=LM_LOGIT_TOL, rtol=LM_LOGIT_TOL)
    held, total, gap = hold_generations(f"lm-mla {name} softmax ragged prefill_batch vs "
                                        "token-by-token", rgens, seq, LM_MARGIN)
    log("lm-mla", f"{name} softmax: ragged prompt of {RAGGED_T} tokens, prefill_batch then "
                  f"{RAGGED_NEW} tokens against token-by-token decode ({pre} steps, {seq_s:.1f} "
                  f"s): logits max abs diff {err:.3e} (tolerance {LM_LOGIT_TOL:g} + "
                  f"{LM_LOGIT_TOL:g}*|ref|); greedy tokens equal at {held} of {total} positions "
                  f"whose top-2 margin exceeds {LM_MARGIN:g} (smallest margin {gap:.3e})")
    del dep, engine, rengine, got, ref, fast, seq, warm
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": res.prefill_seconds,
            "tokens_per_s": SERVE_SLOTS * SERVE_T / res.prefill_seconds,
            "ms_per_tick": (res.seconds - res.prefill_seconds) / res.ticks * 1e3, "peak": peak}


def softmax_logits_fp32(cfg, params, prompts, gens):
    """The kernel-vs-plain logit comparison of lm_softmax_full_width with
    ``cfg``'s dtype float32 on both routes (the same weights, prompts,
    teacher-forced generations and depth): within LM_LOGIT_FP32_TOL."""
    import dataclasses

    import torch
    from repro_torch.kernels.window_attention import ops as wops

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    logits = {}
    for route in ("kernel", "plain"):
        before = wops.launches
        ctx = plain_softmax_attention() if route == "plain" else contextlib.nullcontext()
        with ctx:
            logits[route] = lm_replay(cfg32, params, prompts, SERVE_T, gens, SERVE_MAX_LEN)
        if (wops.launches > before) != (route == "kernel"):
            fail(f"lm-mla {cfg.name} softmax fp32: window_attention launches "
                 f"{wops.launches - before} on the {route} route")
        torch.cuda.empty_cache()
    err = compare(f"lm-mla {cfg.name} softmax logits in float32, kernel vs plain version",
                  logits["kernel"], logits["plain"], atol=LM_LOGIT_FP32_TOL,
                  rtol=LM_LOGIT_FP32_TOL)
    log("lm-mla", f"{cfg.name} softmax, float32 activations on both routes (T {SERVE_T}, "
                  f"{cfg.n_layers} layers, the same prompts and teacher-forced generations): "
                  f"logits max abs diff {err:.3e}, max |ref| "
                  f"{float(logits['plain'].abs().max()):.3e} (tolerance {LM_LOGIT_FP32_TOL:g} + "
                  f"{LM_LOGIT_FP32_TOL:g}*|ref|)")


def phase_lm_mla(recs):
    """MiniCPM3-4B's MLA and full-causal softmax attention served on the
    card.  (a) check_lm_mla_kernels; (b) MiniCPM3-4B (Chimera) through the
    launcher at full width, 2 of 62 layers with lm_serve_full_width's checks
    (c) (the plain versions, a ragged prompt against token-by-token
    decode), then at MLA_DEPTH layers, timed; (c) the softmax variants of
    SOFTMAX_LM at full width, 2 layers.  The smoke configs of both modes run
    card against CPU in phase lm-chimera (d)."""
    import torch

    entries = check_lm_mla_kernels(recs)
    runs = {"2 layers": lm_serve_full_width(MLA_LM),
            f"{MLA_DEPTH} layers": lm_serve_deeper(MLA_LM, MLA_DEPTH)}
    runs.update({f"{name} softmax": lm_softmax_full_width(name) for name in SOFTMAX_LM})
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs["2 layers"]["launches"]}
    # each new shape's launches on this phase's main paths, in the kernels line
    for kernel in ("decode_step", "chimera_attention"):
        entries[kernel]["launches"] = sum(runs[n]["launches"][kernel]
                                          for n in ("2 layers", f"{MLA_DEPTH} layers"))
    for name in SOFTMAX_LM:
        entries[name]["launches"] = runs[f"{name} softmax"]["launches"]["window_attention"]
    torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------------
# 16. lm-ssm (Mamba and xLSTM served on the card)
# --------------------------------------------------------------------------

SSM_JAMBA, SSM_XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
# (slots, prompt tokens) of the served main path.  prefill_batch prefills
# each prompt to its length less one and steps the last token: Jamba's
# 8,193-token prompts give an 8,192-token prefill (32 Chimera chunks of 256,
# 128 Mamba chunks of 64; the MoE's groups of 512 tokens need B x T to be a
# multiple of 512, so no longer prompt at 2 slots), xLSTM's 2,050 a
# 2,049-token one (8 mLSTM chunks of 256 and the ragged tail of 1)
SSM_SERVE = {SSM_JAMBA: (2, SERVE_T + 1), SSM_XLSTM: (4, 2050)}
# prefill against token-by-token decode at full width, 2 slots: a prefill
# of 257 tokens runs the ragged paths (Mamba's 4 chunks of 64 and a 1-token
# tail, which splices the conv carry; mLSTM's chunk of 256 and a 1-token
# tail; Chimera's chunk of 256 and 1 token in the ring)
SSM_RAGGED_T = 258
# the models' profiler scopes around their scans (JAX's named scopes)
SSM_SCOPES = ("mamba", "mlstm", "slstm")


def jamba_cut():
    """Jamba-1.5-Large at full width, 2 of its 72 layers: its pattern's
    position 0 (a Mamba block with the MoE MLP of 16 experts top-2) and an
    attention block (Chimera, 64 heads over 8, d_head 128) with the dense
    MLP of its position 3: 11.91 G parameters, 47.65 GB in float32 (one
    period of 8 layers holds 4 MoE layers, 155 GB)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SSM_JAMBA), n_layers=2, block_pattern=("mamba", "attn"))


def scope_ms(prof, names=SSM_SCOPES):
    """{scope: (kernel ms, span ms, ranges)} for each profiler scope of
    ``names`` (the models' ``record_function`` ranges) in a trace: the
    device time of the kernels launched inside it (its host range's
    children's kernels), and its span on the device's timeline (the trace's
    device-side annotation: from its first kernel's start to its last one's
    end, idle gaps included)."""
    out = {}
    for ev in prof.events():
        if ev.name in names:
            k, span, n = out.get(ev.name, (0.0, 0.0, 0))
            if "CUDA" in str(ev.device_type):
                span += ev.time_range.elapsed_us() / 1e3
            else:
                k, n = k + ev.device_time_total / 1e3, n + 1
            out[ev.name] = (k, span, n)
    return out


def check_lm_ssm_kernels(recs):
    """decode_step (every fill pattern, with and without the globals) and
    the long-chunk kernel at Jamba's attention widths (2 slots x 8 kv-heads,
    Gq 8, d = dv = m 128, L 256; T 8192), against their plain versions,
    timed against their bounds; returns their entries of the kernels line."""
    cfg = jamba_cut()
    slots = SSM_SERVE[SSM_JAMBA][0]
    kv, Gq, d, dv = attn_widths(cfg)
    m, L = cfg.chimera.feature_map.m, cfg.chimera.chunk_size
    entries = {}
    for fill in ZOO_FILLS:
        for with_global in (False, True):
            timed = with_global and fill == "spread"
            r = check_decode(with_global, timed, fill=fill, B=slots, Gq=Gq, d=d, dv=dv, m=m,
                             L=L, heads=kv)
            if timed:
                r["shape"] = f"Jamba: BH {slots * kv} Gq {Gq} d {d} dv {dv} m {m} L {L}"
                entries["decode_step"] = other_shape(recs, "decode_step", r)
    r = check_chimera_long(True, shape=(slots, kv, Gq, SERVE_T, d, dv))
    r["shape"] = "Jamba: " + r["shape"]
    entries["chimera_attention"] = other_shape(recs, "chimera_attention", r)
    return entries


def ssm_serve(cfg, slots, prompt_len, label, warm=True, profile_T=None):
    """``cfg`` through the LM launcher at full width: ``slots`` x
    ``prompt_len``-token prompts through prefill_batch and 16 new tokens
    each, after a warm-up prefill at the same shape (``warm``; cuBLAS picks
    its kernels on a first call), its launches counted from 0 just before
    and read just after; then one profiled prefill (device time by kernel
    and by scan, busy share; logits finite, of the padded vocabulary), of
    the served prompts' first ``profile_T`` tokens if given.
    Returns the deployment, the prompts, the generations and the numbers
    (with the seconds of each stage)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    max_len = prompt_len + 64
    stages, t0 = {}, time.perf_counter()
    dep, nbytes, draw_s = launcher(cfg, prompt_len, slots=slots, max_len=max_len)
    stages["build"] = time.perf_counter() - t0
    engine, pre = dep.engine, prompt_len - 1
    widths = [f"{cfg.pattern.count(k) * cfg.n_groups} {k}" for k in dict.fromkeys(cfg.pattern)]
    if "attn" in cfg.pattern:
        widths.append(f"attention {cfg.n_heads} heads / {cfg.n_kv_heads} kv-heads of "
                      f"{cfg.head_dim}, Chimera m {cfg.chimera.feature_map.m} L "
                      f"{cfg.chimera.chunk_size}")
    if "mamba" in cfg.pattern:
        widths.append(f"Mamba d_inner {cfg.mamba_expand * cfg.d_model} d_state "
                      f"{cfg.mamba_d_state} dt_rank {cfg.mamba_dt_rank or -(-cfg.d_model // 16)} "
                      f"chunk {cfg.mamba_chunk}")
    if "mlstm" in cfg.pattern:
        widths.append(f"{cfg.n_heads} heads, mLSTM dh {2 * cfg.d_model // cfg.n_heads} chunk "
                      f"{cfg.chimera.chunk_size}, sLSTM dh {cfg.d_model // cfg.n_heads}")
    if cfg.moe_experts:
        widths.append(f"{cfg.moe_experts} experts of d_ff {cfg.moe_d_ff} top-{cfg.moe_top_k} at "
                      f"every {cfg.moe_every}th position, else dense d_ff {cfg.d_ff}")
    log("lm-ssm", f"{label}, {cfg.n_layers} of {get_config(cfg.name).n_layers} layers at full "
                  f"width (d {cfg.d_model}, {', '.join(widths)}, vocab {cfg.vocab_size}, dtype "
                  f"{cfg.dtype}): {nbytes // 4} fp32 parameters ({nbytes} B) drawn on the card "
                  f"in {draw_s:.2f} s")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (slots, prompt_len))
    if warm:
        t0 = time.perf_counter()
        lg = lm_replay(cfg, engine.params, prompts, pre, np.zeros((slots, 1), np.int64), max_len)
        if not torch.isfinite(lg).all():
            fail(f"lm-ssm {label}: non-finite logits after the warm-up prefill")
        del lg
        stages["warm-up"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_attn = cfg.n_groups * cfg.pattern.count("attn") if cfg.use_chimera else 0
    res, launches, peak = serve_counted(dep, lambda ticks: {
        "chimera_attention": n_attn, "decode_step": n_attn * ticks, "window_attention": 0},
        "lm-ssm")
    if [r.prompt for r in res.requests] != prompts.tolist():
        fail(f"lm-ssm {label}: the launcher's prompts are not the replays' prompts")
    gens = np.array([r.generated for r in res.requests])
    decode_s = res.seconds - res.prefill_seconds
    stages["serve"] = time.perf_counter() - t0
    log("lm-ssm", f"{label}: {timing_line(res, slots, pre)}; launches {launches}; "
                  f"max_memory_allocated {peak} B")
    t_prof = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    T = profile_T or pre
    tokens = torch.from_numpy(prompts[:, :T]).to("cuda")
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, _ = M.prefill_with_caches(cfg, engine.params, tokens, max_len=max_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms, _ = report_profile(prof, wall, f"one {label} prefill of {slots} x {T} tokens")
    scans = scope_ms(prof)
    log("lm-ssm", f"{label}: each scan in that prefill (profiler scope: device time of its "
                  f"kernels, span on the device, ranges): " + ", ".join(
                      f"{k} {ms:.1f} ms, {span:.1f} ms, {n}" for k, (ms, span, n) in scans.items())
                  + (f"; of {busy_ms:.1f} ms of kernels in {wall * 1e3:.1f} ms" if busy_ms
                     else "; device time not measured"))
    if tuple(logits.shape) != (slots, cfg.padded_vocab) or not torch.isfinite(logits).all():
        fail(f"lm-ssm {label}: prefill logits of shape {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}")
    del logits, tokens
    torch.cuda.empty_cache()
    stages["profiled prefill"] = time.perf_counter() - t_prof
    log("lm-ssm", f"{label}: seconds by stage " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                           stages.items()))
    return dep, prompts, gens, {
        "launches": launches, "prefill_s": res.prefill_seconds, "ticks": res.ticks,
        "tokens_per_s": slots * pre / res.prefill_seconds,
        "ms_per_tick": decode_s / res.ticks * 1e3, "peak": peak, "busy": busy_ms and busy_ms / (wall * 1e3), "prefill_wall_ms": wall * 1e3,
        "kernel_ms": busy_ms, "scans": scans, "stages": stages}


def ssm_prefill_vs_decode(cfg, params, label):
    """A 2 x SSM_RAGGED_T-token prompt through prefill_batch (a ragged
    prefill) and 4 new tokens, drop-free, against token-by-token decode
    (the MoE's near ties routed alike, lm_replay_shared_routes): greedy
    tokens equal where the top-2 margin exceeds LM_MARGIN."""
    import torch
    from repro_torch.serve.engine import Request, ServeEngine

    dcfg, max_len = drop_free(cfg), SSM_RAGGED_T + 64
    rengine = ServeEngine(dcfg, params, batch_slots=2, max_len=max_len, device="cuda")
    rprompts = np.random.default_rng(SEED + 70).integers(0, cfg.vocab_size, (2, SSM_RAGGED_T))
    reqs = [Request(rid=i, prompt=p.tolist(), max_new_tokens=RAGGED_NEW)
            for i, p in enumerate(rprompts)]
    rengine.prefill_batch(reqs)
    rengine.run_until_done()
    rgens = np.array([r.generated for r in reqs])
    pre = SSM_RAGGED_T - 1
    t0 = time.perf_counter()
    fast, seq, ties = lm_replay_shared_routes(dcfg, params, rprompts, pre, rgens, max_len)
    seq_s = time.perf_counter() - t0
    held, total, gap = hold_generations(f"lm-ssm {label} ragged prefill_batch vs token-by-token",
                                        rgens, seq, LM_MARGIN)
    routing = (f"capacity factor {dcfg.capacity_factor:g} (drop-free); the MoE's near ties (top-k "
               f"gap <= {ROUTE_MARGIN:g}) routed as in the prefill: {len(ties)}, (MoE layer, "
               f"slot, position, gap) {ties}" if cfg.moe_experts else "no MoE")
    log("lm-ssm", f"{label}: a {SSM_RAGGED_T}-token prompt x 2, prefill_batch ({pre} tokens) then "
                  f"{RAGGED_NEW} tokens against token-by-token decode ({pre} steps, {seq_s:.1f} s; "
                  f"{routing}): logits max abs diff {float((fast - seq).abs().max()):.3e}; greedy "
                  f"tokens equal at {held} of {total} positions whose top-2 margin exceeds "
                  f"{LM_MARGIN:g} (smallest margin {gap:.3e})")
    del rengine, fast, seq
    torch.cuda.empty_cache()


def phase_lm_ssm(recs):
    """Mamba and xLSTM served on the card.  (a) decode_step and the
    long-chunk kernel at Jamba's attention widths against their plain
    versions, timed; (b) Jamba-1.5-Large at full width, 2 layers
    (``jamba_cut``), through the LM launcher: 2 x 8,193-token prompts, 16
    new tokens each (the main path: chimera_attention in the prefill,
    decode_step every tick, counted), its greedy generations held to the
    plain route on the card (the plain versions of both kernels) where the
    top-2 margin exceeds LM_MARGIN, and a ragged prefill against
    token-by-token decode; (c) xLSTM-125M at full depth and width through
    the launcher: 4 x 2,050-token prompts, 16 new tokens, and the same
    prefill-vs-decode check; (d) both smoke configs card against CPU."""
    import torch
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops

    t0 = time.perf_counter()
    entries = check_lm_ssm_kernels(recs)
    seconds = {"kernels": time.perf_counter() - t0}
    runs = {}
    slots, prompt_len = SSM_SERVE[SSM_JAMBA]
    cfg = jamba_cut()
    dep, prompts, gens, runs[SSM_JAMBA] = ssm_serve(cfg, slots, prompt_len, "Jamba-1.5-Large")
    params = dep.engine.params
    t0 = time.perf_counter()
    before = cops.launches + dops.launches
    with plain_chimera_kernels():
        ref = lm_replay(cfg, params, prompts, prompt_len - 1, gens, prompt_len + 64)
    if cops.launches + dops.launches != before:
        fail("lm-ssm Jamba: a kernel launched on the plain route")
    held, total, gap = hold_generations("lm-ssm Jamba kernels vs plain", gens, ref, LM_MARGIN)
    log("lm-ssm", f"Jamba-1.5-Large: the served generations against the plain route on the card "
                  f"(the plain versions of chimera_attention and decode_step, the same prompts "
                  f"and teacher-forced tokens): equal at {held} of {total} positions whose top-2 "
                  f"margin exceeds {LM_MARGIN:g} (smallest margin {gap:.3e})")
    del ref
    seconds["Jamba plain route"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssm_prefill_vs_decode(cfg, params, "Jamba-1.5-Large")
    seconds["Jamba prefill vs decode"] = time.perf_counter() - t0
    del dep, params
    torch.cuda.empty_cache()

    slots, prompt_len = SSM_SERVE[SSM_XLSTM]
    from repro_torch.configs import get_config

    cfg = get_config(SSM_XLSTM)
    # host-bound (the sLSTM's token loop), so no warm-up prefill; the
    # profile is of 65 tokens a slot: the sLSTM launches ~13 kernels a token
    # and layer, and the 1.1 M profiler events of a 2,049-token prefill take
    # longer to process than the prefill takes to run
    dep, _, _, runs[SSM_XLSTM] = ssm_serve(cfg, slots, prompt_len, "xLSTM-125M", warm=False,
                                           profile_T=65)
    t0 = time.perf_counter()
    ssm_prefill_vs_decode(cfg, dep.engine.params, "xLSTM-125M")
    seconds["xLSTM prefill vs decode"] = time.perf_counter() - t0
    del dep
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for name in (SSM_JAMBA, SSM_XLSTM):
        lm_smoke_card_vs_cpu(name, use_chimera=None, phase="lm-ssm")
    seconds["smoke configs"] = time.perf_counter() - t0
    log("lm-ssm", "seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))

    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in runs[SSM_JAMBA]["launches"]}
    for kernel in ("chimera_attention", "decode_step"):
        if not launches[kernel]:
            fail(f"lm-ssm: {kernel} never launched on the phase's main path: {launches}")
        entries[kernel]["launches"] = launches[kernel]
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------------
# 17. lm-encdec (whisper-tiny's encoder-decoder served on the card)
# --------------------------------------------------------------------------

ENCDEC = "whisper-tiny"
# B 8 segments of 30 s of audio (Te 1,536 frames, padded, as the JAX
# package's launcher sizes whisper's decode); the 448-token text context
ENCDEC_B, ENCDEC_TE, ENCDEC_CTX = 8, 1536, 448
# (c): the softmax cross-attention variant's decoder depth (the encoder keeps
# its 4 layers)
ENCDEC_SOFTMAX_LAYERS = 1
# the float32-activation routes' decode: the forced ticks and 16 greedy ones
# past the Chimera ring's fold at tick 256 (the main path's run decodes all
# 448)
ENCDEC_FP32_TICKS = 272
# the bf16 floor of (a)'s logits: a planted relative error in the frames, and
# the factor on the logits' move under it.  On an H100 80GB HBM3 at 700 W a
# planted 1e-6 moved the 4-layer decoder's bf16 logits by 0.252 (max |logit|
# 5.9), the routes differed by 0.221-0.263, and with float32 activations by
# 5.7e-6 to 7.2e-6 (the planted error there 6.0e-6): at 1 decoder layer
# 6.9e-3, 4.0e-3 to 1.5e-2 (chip_smoke.encdec_route_gaps)
ENCDEC_PLANTED, ENCDEC_FLOOR_FACTOR = 1e-6, 2.0


def encdec_forced_len(cfg):
    """The teacher-forced forward's length: the largest multiple of the
    Chimera chunk (the JAX package needs T % L == 0) within the context."""
    L = cfg.chimera.chunk_size
    return ENCDEC_CTX // L * L


def encdec_decode(cfg, params, emb, feed, n_forced, n_ticks=ENCDEC_CTX):
    """``init_encdec_caches(max_len=ENCDEC_CTX)`` with float32 self caches
    (as the LM engine keeps them), then one ``decode_step`` a token for
    ``n_ticks`` ticks: tick t's input is ``feed[:, t]`` for t < n_forced,
    else the previous tick's argmax (greedy; nothing leaves the card until
    the last tick).  Returns (logits (B, ticks, vocab) float32 on the host,
    inputs (B, ticks), caches' seconds, decode seconds)."""
    import torch
    from repro_torch.models import model as M

    B = emb.shape[0]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches = M.init_encdec_caches(cfg, params, emb, B, ENCDEC_CTX, dtype=torch.float32)
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        feed = torch.from_numpy(np.asarray(feed)).to("cuda")
        tok, inputs, out = feed[:, 0], [], []
        t0 = time.perf_counter()
        for t in range(n_ticks):
            if t < n_forced:
                tok = feed[:, t]
            inputs.append(tok)
            lg = M.decode_step(cfg, params, tok, torch.full((B,), t, dtype=torch.int32,
                                                             device="cuda"), caches)
            lg = lg[:, :cfg.vocab_size]
            tok = torch.argmax(lg, dim=-1)
            out.append(lg.float())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    return (torch.stack(out, 1).cpu(), torch.stack(inputs, 1).cpu().numpy(), cache_s,
            decode_s)


def encdec_run(label, cfg, params, emb, toks, n_encode=3):
    """The main path on the card, with every kernel's count zeroed just
    before and read just after: ``encode`` (``n_encode`` times, timed each;
    the first call pays cuBLAS's choices),
    the teacher-forced ``forward`` at encdec_forced_len (twice, timed each),
    then encdec_decode (T forced tokens, then greedy to the context's end).
    Returns the outputs, the counts and the timings."""
    import torch
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.window_attention import ops as wops
    from repro_torch.models import model as M

    T = encdec_forced_len(cfg)
    emb_d = torch.from_numpy(emb).to("cuda")
    batch = {"tokens": torch.from_numpy(toks[:, :T]).to("cuda"), "enc_embeds": emb_d}
    torch.cuda.reset_peak_memory_stats()
    wops.launches = wops.noncausal_launches = cops.launches = dops.launches = 0
    enc_ms, fwd_ms = [], []
    with torch.no_grad():
        for _ in range(n_encode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = M.encode(cfg, params, emb_d)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = M.forward(cfg, params, batch)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
    logits = logits[..., :cfg.vocab_size].float().cpu()
    dec, inputs, cache_s, decode_s = encdec_decode(cfg, params, emb_d, toks, T)
    launches = {"window_attention": wops.launches, "noncausal": wops.noncausal_launches,
                "chimera_attention": cops.launches, "decode_step": dops.launches}
    peak = torch.cuda.max_memory_allocated()
    # every encode (n_encode, one in each forward, one in init_encdec_caches)
    # runs the non-causal mode in each encoder layer; the decoder's
    # self-attention is Chimera (chimera_attention per forward, decode_step
    # per tick) or full-causal softmax (window_attention at W = T per
    # forward), its softmax cross-attention the non-causal mode (per forward
    # and per tick)
    n_enc = (n_encode + 2 + 1) * cfg.encoder_layers
    n_dec = cfg.n_layers
    want = ({"noncausal": n_enc, "chimera_attention": 2 * n_dec,
             "decode_step": ENCDEC_CTX * n_dec} if cfg.use_chimera else
            {"noncausal": n_enc + (2 + ENCDEC_CTX) * n_dec, "chimera_attention": 0,
             "decode_step": 0})
    want["window_attention"] = want["noncausal"] + (0 if cfg.use_chimera else 2 * n_dec)
    for k, n in want.items():
        if launches[k] != n:
            fail(f"lm-encdec {label}: {k} launched {launches[k]} times on the main path, "
                 f"want {n}: {launches}")
    if not (torch.isfinite(enc).all() and torch.isfinite(logits).all()
            and torch.isfinite(dec).all()):
        fail(f"lm-encdec {label}: non-finite encoder output or logits")
    if tuple(enc.shape) != (ENCDEC_B, ENCDEC_TE, cfg.d_model) or tuple(logits.shape) != (
            ENCDEC_B, T, cfg.vocab_size):
        fail(f"lm-encdec {label}: encoder output {tuple(enc.shape)}, logits "
             f"{tuple(logits.shape)}")
    log("lm-encdec", f"{label}: encode ms {', '.join(f'{x:.2f}' for x in enc_ms)} (B "
                     f"{ENCDEC_B} x Te {ENCDEC_TE}); forward ms "
                     f"{', '.join(f'{x:.2f}' for x in fwd_ms)} (encode + decoder at T {T}); "
                     f"init_encdec_caches {cache_s * 1e3:.2f} ms; decode "
                     f"{decode_s / ENCDEC_CTX * 1e3:.3f} ms per tick over {ENCDEC_CTX} ticks "
                     f"({T} teacher-forced, {ENCDEC_CTX - T} greedy; {ENCDEC_B} tokens a tick); "
                     f"max_memory_allocated {peak} B; launches {launches}")
    return {"enc": enc.float().cpu(), "logits": logits, "dec": dec, "inputs": inputs,
            "launches": launches, "encode_ms": enc_ms, "forward_ms": fwd_ms,
            "tick_ms": decode_s / ENCDEC_CTX * 1e3, "peak": peak}


def encdec_profile(label, cfg, params, emb, toks, ticks=16):
    """``ticks`` teacher-forced decode ticks after one warm tick, under the
    profiler: device time by kernel and the device's busy share of a tick
    (outside the main path's counted run)."""
    import torch
    from repro_torch.models import model as M

    B = emb.shape[0]
    emb_d = torch.from_numpy(emb).to("cuda")
    tk = torch.from_numpy(toks).to("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        caches = M.init_encdec_caches(cfg, params, emb_d, B, ENCDEC_CTX, dtype=torch.float32)

        def tick(t):
            M.decode_step(cfg, params, tk[:, t], torch.full((B,), t, dtype=torch.int32,
                                                            device="cuda"), caches)

        tick(0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for t in range(1, ticks + 1):
                tick(t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    report_profile(prof, wall, f"lm-encdec {label}: {ticks} decode ticks of B {B}")


def encdec_forward(cfg, params, emb_d, tokens, route):
    """(encoder output, forward logits) on the card, float32 on the host, on
    the kernel route or the plain one (no kernel launch allowed there)."""
    import torch
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.window_attention import ops as wops
    from repro_torch.models import model as M

    before = wops.launches + cops.launches + dops.launches
    with contextlib.ExitStack() as st, torch.no_grad():
        if route == "plain":
            st.enter_context(plain_chimera_kernels())
            st.enter_context(plain_window_attention())
        enc = M.encode(cfg, params, emb_d).float().cpu()
        logits, _ = M.forward(cfg, params, {"tokens": tokens, "enc_embeds": emb_d})
    if (wops.launches + cops.launches + dops.launches > before) != (route == "kernel"):
        fail(f"lm-encdec {cfg.name}: kernel launches on the {route} route")
    return enc, logits[..., :cfg.vocab_size].float().cpu()


def encdec_bf16_floor(label, cfg, params, emb, run):
    """(a) in the main path's types: the encoder output on the plain route
    within LM_LOGIT_FP32_TOL (the encoder is float32: its adapter's float32
    weights promote the frames), and the forward logits within the bf16
    floor of this network: ENCDEC_FLOOR_FACTOR x how far the kernel route's
    own logits move under a planted relative error of ENCDEC_PLANTED in the
    frames (any change flips bf16 roundings of the decoder's residual
    stream, which its random-weight layers carry on; the kernels' own
    difference is held in float32, encdec_fp32_routes), and at least
    LM_LOGIT_TOL."""
    import torch

    T = encdec_forced_len(cfg)
    emb_d = torch.from_numpy(emb).to("cuda")
    tokens = torch.from_numpy(run["inputs"][:, :T]).to("cuda")
    enc, logits = encdec_forward(cfg, params, emb_d, tokens, "plain")
    noise = torch.from_numpy(np.random.default_rng(SEED + 91).standard_normal(emb.shape)
                             .astype(np.float32)).to("cuda")
    _, planted = encdec_forward(cfg, params, emb_d * (1 + ENCDEC_PLANTED * noise), tokens,
                                "kernel")
    floor = float((planted - run["logits"]).abs().max())
    tol = max(LM_LOGIT_TOL, ENCDEC_FLOOR_FACTOR * floor)
    e_enc = compare(f"lm-encdec {label} encoder output kernel vs plain", run["enc"], enc,
                    atol=LM_LOGIT_FP32_TOL, rtol=LM_LOGIT_FP32_TOL)
    e_fwd = compare(f"lm-encdec {label} bf16 forward logits kernel vs plain", run["logits"],
                    logits, atol=tol, rtol=0.0)
    log("lm-encdec", f"{label} (a) in the main path's types (bf16 decoder), kernel route against "
                     f"the plain route on the card: encoder output max abs diff {e_enc:.3e} "
                     f"(tolerance {LM_LOGIT_FP32_TOL:g} + {LM_LOGIT_FP32_TOL:g}*|ref|); forward "
                     f"logits {e_fwd:.3e}, max |logit| {float(logits.abs().max()):.3e}, against "
                     f"the kernel route's own move under a planted {ENCDEC_PLANTED:g} relative "
                     f"error in the frames, {floor:.3e} (tolerance {tol:.3e})")


def encdec_fp32_routes(label, cfg, params, emb, toks, n_ticks):
    """(a) and (b) with float32 activations (``cfg`` at dtype float32; the
    same weights and the same kernel calls, whose inputs are float32 in
    either dtype), where no bf16 rounding stands between the routes: the
    kernel route (encode, forward at T, decode for ``n_ticks`` ticks, T
    forced then greedy) against the plain route fed the same tokens:
    encoder output and forward and decode logits within LM_LOGIT_FP32_TOL,
    greedy tokens equal where the plain route's top-2 margin exceeds
    LM_MARGIN; and the kernel route's decode against its forward over the T
    forced ticks within LM_LOGIT_FP32_TOL, argmax equal where the margin
    exceeds LM_MARGIN."""
    import dataclasses

    import torch

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    T = encdec_forced_len(cfg)
    emb_d = torch.from_numpy(emb).to("cuda")
    tokens = torch.from_numpy(toks[:, :T]).to("cuda")
    out = {}
    for route in ("kernel", "plain"):
        enc, logits = encdec_forward(cfg32, params, emb_d, tokens, route)
        with contextlib.ExitStack() as st:
            if route == "plain":
                st.enter_context(plain_chimera_kernels())
                st.enter_context(plain_window_attention())
            feed = toks if route == "kernel" else out["kernel"][3]
            dec, inputs, _, _ = encdec_decode(cfg32, params, emb_d, feed,
                                              T if route == "kernel" else n_ticks, n_ticks)
        out[route] = (enc, logits, dec, inputs)
        torch.cuda.empty_cache()
    (ek, lk, dk, _), (ep, lp, dp, _) = out["kernel"], out["plain"]
    tol = LM_LOGIT_FP32_TOL
    errs = [compare(f"lm-encdec {label} fp32 {what} kernel vs plain", a, b, atol=tol, rtol=tol)
            for what, a, b in (("encoder output", ek, ep), ("forward logits", lk, lp),
                               ("decode logits", dk, dp))]
    held, total, gap = hold_generations(f"lm-encdec {label} fp32 kernels vs plain",
                                        torch.argmax(dk, dim=-1).numpy(), dp, LM_MARGIN)
    worst = compare(f"lm-encdec {label} fp32 decode vs forward", dk[:, :T], lk, atol=tol,
                    rtol=tol)
    held_b, total_b, gap_b = hold_generations(f"lm-encdec {label} fp32 decode vs forward",
                                              torch.argmax(dk[:, :T], dim=-1).numpy(), lk,
                                              LM_MARGIN)
    log("lm-encdec", f"{label} (a) float32 activations, kernel route against the plain route on "
                     f"the card ({n_ticks} decode ticks, {T} forced): encoder output, forward "
                     f"and decode logits max abs diff {errs[0]:.3e}, {errs[1]:.3e}, {errs[2]:.3e} "
                     f"(tolerance {tol:g} + {tol:g}*|ref|); greedy tokens equal at {held} of "
                     f"{total} positions whose top-2 margin exceeds {LM_MARGIN:g} (smallest "
                     f"margin {gap:.3e})")
    log("lm-encdec", f"{label} (b) float32 activations, decode_step against the teacher-forced "
                     f"forward over {T} ticks (kernel route): worst logit gap {worst:.3e} "
                     f"(tolerance {tol:g} + {tol:g}*|ref|); argmax equal at {held_b} of "
                     f"{total_b} positions whose top-2 margin exceeds {LM_MARGIN:g} (smallest "
                     f"margin {gap_b:.3e})")


def encdec_decode_vs_forward(label, cfg, run):
    """(b) in the main path's types: the kernel route's decode at the T
    teacher-forced ticks against its own teacher-forced forward (two
    summation orders through a bf16 residual stream): the worst logit gap
    printed; argmax equal where the forward's top-2 margin exceeds
    LM_MARGIN."""
    import torch

    T = encdec_forced_len(cfg)
    held, total, gap = hold_generations(f"lm-encdec {label} bf16 decode vs forward",
                                        torch.argmax(run["dec"][:, :T], dim=-1).numpy(),
                                        run["logits"], LM_MARGIN)
    worst = float((run["dec"][:, :T] - run["logits"]).abs().max())
    log("lm-encdec", f"{label} (b) in the main path's types, decode_step against the "
                     f"teacher-forced forward over {T} ticks (kernel route): worst logit gap "
                     f"{worst:.3e}; argmax equal at {held} of {total} positions whose top-2 "
                     f"margin exceeds {LM_MARGIN:g} (smallest margin {gap:.3e})")
    return worst


def encdec_route_gaps(n_layers=None, planted=1e-6):
    """Diagnosis of the kernel-vs-plain gap of whisper-tiny's forward logits
    (T 256, B 8, full width; ``n_layers`` decoder layers, all by default):
    each route combination (the encoder's non-causal softmax and the
    decoder's chimera_attention, kernel or plain) against the kernel route,
    in the config's bf16 and with float32 activations; and the kernel
    route's own response to a planted relative error ``planted`` in the
    frame embeddings (how far the random-weight network carries a perturbation)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(ENCDEC)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    rng = np.random.default_rng(SEED + 90)
    emb = rng.standard_normal((ENCDEC_B, ENCDEC_TE, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (ENCDEC_B, ENCDEC_CTX))
    T = encdec_forced_len(cfg)
    tk = torch.from_numpy(toks[:, :T]).to("cuda")
    e = torch.from_numpy(emb).to("cuda")
    noise = torch.from_numpy(rng.standard_normal(emb.shape).astype(np.float32)).to("cuda")
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        out = {}
        for enc_route in ("kernel", "plain"):
            for dec_route in ("kernel", "plain"):
                with contextlib.ExitStack() as st, torch.no_grad():
                    if enc_route == "plain":
                        st.enter_context(plain_window_attention())
                    if dec_route == "plain":
                        st.enter_context(plain_chimera_kernels())
                    out[enc_route, dec_route] = M.forward(
                        c, params, {"tokens": tk, "enc_embeds": e})[0][..., :c.vocab_size].float()
        with torch.no_grad():
            planted_lg = M.forward(c, params, {"tokens": tk, "enc_embeds": e * (1 + planted * noise)}
                                   )[0][..., :c.vocab_size].float()
        ref = out["kernel", "kernel"]
        log("lm-encdec", f"route gaps, {dtype} activations, {cfg.n_layers} decoder layers: max "
                         f"|logit| {float(ref.abs().max()):.3e}; against the kernel route, "
                         + ", ".join(f"encoder {a} + decoder {b} {float((v - ref).abs().max()):.3e}"
                                     for (a, b), v in out.items())
                         + f"; a planted relative error of {planted:g} in the frames "
                           f"{float((planted_lg - ref).abs().max()):.3e}")
        del out, planted_lg, ref
        torch.cuda.empty_cache()


def check_lm_encdec_kernels(recs):
    """decode_step and chimera_attention (the long-chunk kernel) at
    whisper-tiny's decoder widths (B 8 x 6 heads, Gq 1, d = dv = 64, m 128,
    L 256; T 256) against their plain versions, timed; returns their entries
    of the kernels line."""
    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC)
    kv, Gq, d, dv = attn_widths(cfg)
    m, L = cfg.chimera.feature_map.m, cfg.chimera.chunk_size
    entries = {}
    for fill in ("spread", "all"):  # the timed spread, and every row folding
        timed = fill == "spread"
        r = check_decode(True, timed, fill=fill, B=ENCDEC_B, Gq=Gq, d=d, dv=dv, m=m, L=L,
                         heads=kv)
        if timed:
            r["shape"] = f"whisper-tiny: BH {ENCDEC_B * kv} Gq {Gq} d {d} dv {dv} m {m} L {L}"
            entries["decode_step"] = other_shape(recs, "decode_step", r)
    r = check_chimera_long(True, shape=(ENCDEC_B, kv, Gq, encdec_forced_len(cfg), d, dv))
    r["shape"] = "whisper-tiny: " + r["shape"]
    entries["chimera_attention"] = other_shape(recs, "chimera_attention", r)
    return entries


def phase_lm_encdec(recs):
    """whisper-tiny's encoder-decoder served on the card at full width and
    depth (4 + 4 layers, d 384, 6 heads of 64, vocabulary 51,865), bf16,
    random weights from SEED, stub frame embeddings from a numpy seed: B 8
    x Te 1,536 frames, the teacher-forced forward at T 256 (the chunk L 256
    fits the 448-token context once), then 448 decode ticks (256 forced,
    192 greedy; the Chimera ring folds at 256).  (a) the kernel route
    against the plain route on the card, in the main path's types against
    the network's bf16 floor (encdec_bf16_floor) and with float32
    activations within LM_LOGIT_FP32_TOL, greedy tokens at LM_MARGIN
    (encdec_fp32_routes); (b) decode against the teacher-forced forward,
    the same two ways; (c) all of it for the softmax cross-attention
    variant at ENCDEC_SOFTMAX_LAYERS decoder layer; (d) the timings, peak
    memory and launches of the main path (encdec_run).  Decode_step and
    chimera_attention at the decoder's widths against their plain versions
    first."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_flatten

    t0 = time.perf_counter()
    entries = check_lm_encdec_kernels(recs)
    seconds = {"kernels": time.perf_counter() - t0}
    cfg = get_config(ENCDEC)
    rng = np.random.default_rng(SEED + 90)
    emb = rng.standard_normal((ENCDEC_B, ENCDEC_TE, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (ENCDEC_B, ENCDEC_CTX))
    launches = {"window_attention": 0, "chimera_attention": 0, "decode_step": 0}
    runs = {}
    for label, c in (("whisper-tiny", cfg),
                     (f"whisper-tiny softmax cross-attention, {ENCDEC_SOFTMAX_LAYERS} decoder "
                      f"layer", dataclasses.replace(cfg, use_chimera=False,
                                                    n_layers=ENCDEC_SOFTMAX_LAYERS))):
        t0 = time.perf_counter()
        params = M.init_model(c, torch.Generator(device="cuda").manual_seed(SEED + len(runs)),
                              device="cuda")
        n = sum(t.numel() for t in tree_flatten(params)[0])
        log("lm-encdec", f"{label}: {c.encoder_layers} encoder + {c.n_layers} decoder layers, d "
                         f"{c.d_model}, {c.n_heads} heads of {c.head_dim}, d_ff {c.d_ff}, vocab "
                         f"{c.vocab_size}, {c.norm_type}, dtype {c.dtype}, "
                         + (f"Chimera m {c.chimera.feature_map.m} L {c.chimera.chunk_size} "
                            f"n_global {c.chimera.n_global}" if c.use_chimera else "softmax")
                         + f": {n} fp32 parameters drawn on the card")
        run = encdec_run(label, c, params, emb, toks)
        encdec_profile(label, c, params, emb, toks)
        encdec_bf16_floor(label, c, params, emb, run)
        run["worst_gap"] = encdec_decode_vs_forward(label, c, run)
        encdec_fp32_routes(label, c, params, emb, toks, ENCDEC_FP32_TICKS)
        for k in launches:
            launches[k] += run["launches"][k]
        runs[label] = {k: run[k] for k in ("launches", "encode_ms", "forward_ms", "tick_ms",
                                           "peak", "worst_gap")}
        seconds[label] = time.perf_counter() - t0
        del params, run
        torch.cuda.empty_cache()
    log("lm-encdec", "seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                     seconds.items()))
    for kernel in launches:
        if not launches[kernel]:
            fail(f"lm-encdec: {kernel} never launched on the phase's main path: {launches}")
    for kernel in ("chimera_attention", "decode_step"):
        entries[kernel]["launches"] = launches[kernel]
    return {"launches": launches, "runs": runs}



# --------------------------------------------------------------------------
# 14. train-softmax (softmax attention trained on the card)
# --------------------------------------------------------------------------

# the backward kernels against window_attention_bwd_plain on the same (q, k,
# v, o, lse, do), per tensor: fp32 sums over up to G x W terms in other
# orders, within WIN_BWD_ATOL * max|ref| + WIN_BWD_RTOL * |ref|; bf16: each
# side rounds its fp32 result to bf16 once (one bf16 ulp apart at most,
# 2^-7 relative), within WIN_BWD_BF16_ATOL * max|ref| + WIN_BF16_TOL * |ref|;
# max|ref| is the largest of dq, dk and dv of a slice.
# The forward's lse against window_attention_lse_plain: ATOL + RTOL * |ref|.
WIN_BWD_ATOL, WIN_BWD_RTOL = 1e-5, 1e-4
WIN_BWD_BF16_ATOL = 1e-4
# (b) and (c): full width, 2 layers, B 1 x seq 8192, 1 warm-up + 5 timed
# AdamW steps through the Trainer (remat "full", the configs' default)
SOFTMAX_TRAIN = ("mixtral-8x7b", "minicpm3-4b")
SOFTMAX_TRAIN_LAYERS, SOFTMAX_TRAIN_T, SOFTMAX_TRAIN_STEPS = 2, 8192, 5
# the whole step, kernel route against plain route on the card, fp32, 2
# layers at seq 2048 (Mixtral's window cut to 1024, so the band still cuts):
# the plain route's dense (T, T) scores fit there.  Loss and gradient norm
# within REF_LOSS_RTOL; every leaf's ||g_kernel - g_plain|| / ||g_plain||
# within STEP_GRAD_RTOL (fp32 sums in other orders through attention, the
# MoE and the head: ~1e-6 expected)
STEP_CMP_T, STEP_CMP_W = 2048, 1024
STEP_GRAD_RTOL = 1e-3
SOFTMAX_SMOKE_STEPS, SOFTMAX_SMOKE_WINDOW = 10, 8  # (d): the smoke configs, card against CPU
PEAK_LIMIT = 80e9  # bytes: the card's 80 GB, which a full-width training run stays below


def event_ms(fn, iters, warmup=1):
    """Milliseconds per call from CUDA events around ``iters`` calls issued
    from Python (no CUDA graph: autograd's backward is among the calls
    timed).  For calls of milliseconds and more, where the launch overhead
    is noise."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def window_bwd_cost(B, H, Hkv, T, W, d, dv, esize, Tk=None):
    """Bytes and flops of the backward: q, o, do and lse (fp32) read once,
    k and v per kv-head, dq, dk and dv written once; five products over the
    pairs (S = q k^T and dq, dk: 2 d flop a pair each; dP = do v^T and dv:
    2 dv each): the in-band pairs of the causal mode, or with ``W`` None
    (the non-causal mode) all T x Tk pairs of T query rows and Tk keys."""
    if W is None:
        pairs = T * Tk
    else:
        n1, Tk = min(T, W), T
        pairs = n1 * (n1 + 1) // 2 + (T - n1) * W
    rows, kv_rows = B * H * T, B * Hkv * Tk
    nbytes = esize * (2 * rows * (d + 2 * dv) + 2 * kv_rows * (d + dv)) + 4 * rows
    return nbytes, B * H * pairs * (6 * d + 4 * dv)


def check_window_bwd(shape, dtype, seed, slice_heads=WIN_PLAIN_HEADS, timed=False):
    """The backward at ``shape`` = (B, H, Hkv, T, W, d, dv) in ``dtype``:
    the forward kernel's lse against the plain one; dq, dk, dv through the
    autograd Function (the forward and backward kernels) against
    window_attention_bwd_plain on the kernel's own o and lse, over slices of
    ``slice_heads`` query heads; a second backward launch on the same inputs
    bit for bit equal to the first.  ``timed``: the backward alone, the
    forward with lse (against its own bound at the inputs' type), forward +
    backward, the plain version over all slices, and
    ``scaled_dot_product_attention``'s backward alone (the library column)
    and forward + backward, against the bound.  Returns the record."""
    import torch
    from repro_torch.kernels.window_attention import ops

    B, H, Hkv, T, W, d, dv = shape
    G = H // Hkv
    dt = getattr(torch, dtype)
    q, k, v = window_inputs(B, H, Hkv, T, d, dv, seed, dt)
    g = torch.Generator().manual_seed(seed + 1000)
    do = torch.randn((B, H, T, dv), generator=g).to("cuda", dt)
    o, lse = ops.window_attention_fwd(q, k, v, W)
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = ops.sliding_window_attention(*xs, W)
    if not torch.equal(out.detach(), o):
        fail(f"window_attention backward {shape} {dtype}: the Function's forward differs from "
             "the forward kernel's")
    got = torch.autograd.grad(out, xs, do)
    del out, xs
    again = ops.window_attention_bwd(q, k, v, o, lse, do, W)
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if a.dtype != dt or not torch.equal(a, b):
            fail(f"window_attention backward {shape} {dtype}: {name} of two launches on the same "
                 f"inputs differ (or dtype {a.dtype})")
    del again
    hs = max(G, slice_heads // G * G)  # whole kv-heads per slice
    slices = [(b, h0) for b in range(B) for h0 in range(0, H, hs)]

    def plain(b, h0):
        kv = slice(h0 // G, (h0 + hs) // G)
        f = [x.float() for x in (q[b, h0:h0 + hs], k[b, kv], v[b, kv], o[b, h0:h0 + hs],
                                 do[b, h0:h0 + hs])]
        return ops.window_attention_bwd_plain(f[0], f[1], f[2], f[3], lse[b, h0:h0 + hs], f[4],
                                              W)

    errs = {"lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    bf16 = dt == torch.bfloat16
    atol, rtol = (WIN_BWD_BF16_ATOL, WIN_BF16_TOL) if bf16 else (WIN_BWD_ATOL, WIN_BWD_RTOL)
    label = f"window_attention backward B {B} x H {H} (Hkv {Hkv}) T {T} W {W} d {d} dv {dv} {dtype}"
    with torch.no_grad():
        for b, h0 in slices:
            kv = slice(h0 // G, (h0 + hs) // G)
            kf = k[b, kv].float().repeat_interleave(G, dim=0)
            want = ops.window_attention_lse_plain(q[b, h0:h0 + hs].float(), kf, W)
            errs["lse"] = max(errs["lse"], compare(f"{label} lse", lse[b, h0:h0 + hs], want))
            del kf, want
            wants = plain(b, h0)
            # the floor scales with the largest gradient of the slice: where W = 1
            # dq and dk are 0 but for roundings of dP - D on both sides
            scale = max(float(w.abs().max()) for w in wants)
            for name, a, w in zip(("dq", "dk", "dv"),
                                  (got[0][b, h0:h0 + hs], got[1][b, kv], got[2][b, kv]), wants):
                if bf16:
                    w = w.to(dt).float()
                e = compare(f"{label} {name} b {b} heads {h0}..{h0 + hs - 1}", a.float(), w,
                            atol=atol * scale, rtol=rtol)
                errs[name] = max(errs[name], e)
            del wants
            torch.cuda.empty_cache()
    log("train-softmax", f"{label}: max abs err lse {errs['lse']:.3e}, dq {errs['dq']:.3e}, dk "
                         f"{errs['dk']:.3e}, dv {errs['dv']:.3e} against the plain version over "
                         f"{len(slices)} slices of {hs} heads (tolerance {atol:g}*max|ref of "
                         f"dq, dk, dv| + "
                         f"{rtol:g}*|ref|; lse {ATOL:g} + {RTOL:g}*|ref|); two launches bit for bit "
                         f"equal")
    rec = {"max_abs_err": max(errs[n] for n in ("dq", "dk", "dv")), "errs": errs,
           "shape": f"B {B} x H {H} (Hkv {Hkv}) T {T} W {W} d {d} dv {dv} {dtype}"}
    if timed:
        with torch.no_grad():
            ms = event_ms(lambda: ops.window_attention_bwd(q, k, v, o, lse, do, W), iters=3)
            fwd_ms = event_ms(lambda: ops.window_attention_fwd(q, k, v, W), iters=3)
            fb_ms = event_ms(lambda: ops.window_attention_bwd(
                q, k, v, *ops.window_attention_fwd(q, k, v, W), do, W), iters=3)
            plain_ms = event_ms(lambda: [plain(b, h0) for b, h0 in slices], iters=1)
        library_ms, lib_fb_ms = sdpa_bwd_ms(q, k, v, do, W)
        nbytes, flops = window_bwd_cost(B, H, Hkv, T, W, d, dv, q.element_size())
        fwd_bytes, fwd_flops = window_cost(B, H, Hkv, T, W, d, dv, q.element_size())
        fwd_bytes += 4 * B * H * T  # the lse
        if bf16:  # bf16 operands take the bf16 tensor cores whole, no split
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
            fwd_bound_ms, fwd_bound_by = bound(fwd_bytes, fwd_flops, BF16_FLOPS)
            rate = "in bf16 on the tensor cores"
        else:
            bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
            fwd_bound_ms, fwd_bound_by = bound(fwd_bytes, TF32_PASSES * fwd_flops, TF32_FLOPS)
            rate = f"x{TF32_PASSES} in TF32 on the tensor cores"
        fp32_ms = flops / FP32_FLOPS * 1e3
        split = profiled_kernel_ms(lambda: ops.window_attention_bwd(q, k, v, o, lse, do, W),
                                   WIN_BWD_KERNELS, iters=5)
        rec.update(ms=ms, fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms,
                   library_of="backward alone (its forward outside the timed window)",
                   library_fwd_bwd_ms=lib_fb_ms, fwd_bound_ms=fwd_bound_ms, bytes=nbytes,
                   flops=flops)
        log("train-softmax", f"{label} device time: backward {ms:.4f} ms (3 launches), forward "
                             f"with lse {fwd_ms:.4f} ms (bound {fwd_bound_ms:.4f} ms by "
                             f"{fwd_bound_by}: {fwd_bytes} B; {fwd_flops} flop, {rate}), forward "
                             f"+ backward {fb_ms:.4f} ms; bound of the backward {bound_ms:.4f} ms "
                             f"by {bound_by} ({nbytes} B; {flops} flop, {rate}; on the fp32 CUDA "
                             f"cores {fp32_ms:.4f} ms); scaled_dot_product_attention backward "
                             f"alone {fmt_ms(library_ms)}, forward + backward {fmt_ms(lib_fb_ms)}; "
                             f"plain backward {plain_ms:.4f} ms over its {len(slices)} slices; "
                             f"in a profiler trace (ms a launch, launches) "
                             + ", ".join(f"{x} {fmt_ms(t and t[0])} ({t and t[1]})"
                                         for x, t in split.items()))
    del q, k, v, o, lse, do, got
    torch.cuda.empty_cache()
    return rec


# the backward's three kernels, as a profiler names them
WIN_BWD_KERNELS = ("window_bwd_rowdot", "window_bwd_dkdv", "window_bwd_dq")


def sdpa_bwd_ms(q, k, v, do, W):
    """``(backward alone, forward + backward)`` of
    ``scaled_dot_product_attention`` (K and V repeated to the query heads;
    the band as a boolean mask, or causal where W >= T, on the
    memory-efficient backend, since the math one forms (BH, T, T); no mask
    and PyTorch's choice of backend where ``W`` is None: the non-causal
    mode, as check_noncausal times its forward).  The backward alone is the
    library column: its forward runs once outside the timed window, and
    ``torch.autograd.grad(..., retain_graph=True)`` is timed."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    T, G = q.shape[2], q.shape[1] // k.shape[1]
    idx = torch.arange(T, device="cuda")
    band = None if W is None else (
        ((idx[:, None] - idx[None, :]) >= 0) & ((idx[:, None] - idx[None, :]) < W))
    xs = [q.detach().requires_grad_(True)] + [
        x.repeat_interleave(G, dim=1).detach().requires_grad_(True) for x in (k, v)]

    def fwd():
        if W is None:
            return torch.nn.functional.scaled_dot_product_attention(*xs, is_causal=False)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            if W >= T:
                return torch.nn.functional.scaled_dot_product_attention(*xs, is_causal=True)
            return torch.nn.functional.scaled_dot_product_attention(*xs, attn_mask=band)

    iters = 20 if W is None else 2  # the non-causal calls take a fraction of a millisecond
    try:
        fb_ms = event_ms(lambda: torch.autograd.grad(fwd(), xs, do), iters=iters)
        out = fwd()
        bwd_ms = event_ms(lambda: torch.autograd.grad(out, xs, do, retain_graph=True),
                          iters=iters)
        return bwd_ms, fb_ms
    except RuntimeError as e:  # the library column is part of the kernels line
        fail(f"scaled_dot_product_attention forward + backward refused the main path's "
             f"shape: {str(e)[:200]}")
    finally:
        out = None
        del xs, band
        torch.cuda.empty_cache()


def window_bwd_shapes():
    """(B, H, Hkv, T, W, d, dv) of the backward at Mixtral-8x7B's training
    shape and at MiniCPM3-4B's (W = T)."""
    from repro_torch.configs import get_config

    kv, Gq, d, dv = attn_widths(get_config("mixtral-8x7b"))
    mix = (1, kv * Gq, kv, SOFTMAX_TRAIN_T, get_config("mixtral-8x7b").sliding_window, d, dv)
    kv, Gq, d, dv = attn_widths(get_config(MLA_LM))
    return mix, (1, kv * Gq, kv, SOFTMAX_TRAIN_T, SOFTMAX_TRAIN_T, d, dv)


def check_window_bwd_kernels(recs):
    """(a) The backward at Mixtral-8x7B's training shape (B 1 x H 32 over 8,
    T 8192, W 4096, d = dv = 128) in bf16 (the main path's type, timed) and
    fp32, at MiniCPM3-4B's W = T = 8192 (H = Hkv 40, d 96, dv 64; bf16 timed,
    fp32), and at every edge shape at every (d, dv) the kernels take, fp32
    and bf16.  Returns the kernels line's record (Mixtral's shape) with
    MiniCPM3-4B's as another shape."""
    from repro_torch.kernels.window_attention import ops

    shape, mla = window_bwd_shapes()
    rec = check_window_bwd(shape, "bfloat16", SEED + 80, timed=True)
    check_window_bwd(shape, "float32", SEED + 81)
    other = check_window_bwd(mla, "bfloat16", SEED + 82, timed=True)
    check_window_bwd(mla, "float32", SEED + 83)
    other["shape"] = f"{MLA_LM} softmax: " + other["shape"]
    rec["other_shapes"] = [{k: other.get(k) for k in (
        "shape", "max_abs_err", "ms", "fwd_ms", "fwd_bound_ms", "fwd_bwd_ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms", "library_fwd_bwd_ms")}]
    worst = 0.0
    for i, (T, W, _, H, Hkv) in enumerate(WINDOW_EDGES):
        for dk, dvk in ops.DIMS_TAKEN:
            for dtype in ("float32", "bfloat16"):
                r = check_window_bwd((2, H, Hkv, T, W, dk, dvk), dtype, SEED + 84 + i,
                                     slice_heads=H)
                worst = max(worst, r["max_abs_err"])
    log("train-softmax", f"window_attention backward at {len(WINDOW_EDGES)} edge shapes x "
                         f"{len(ops.DIMS_TAKEN)} (d, dv) x fp32 and bf16: max abs err "
                         f"{worst:.3e}, all within tolerance, every pair of launches bit for bit "
                         f"equal")
    recs["window_attention_bwd"] = rec
    return rec


class plain_window_attention:
    """Within the block the model's attention runs the plain banded softmax
    (``sliding_window_attention_plain``, dense (T, T) scores,
    differentiated by autograd) on the card: the SWA route and the
    full-causal one (``blockwise_softmax_attention`` on the card calls the
    window wrapper at W = T); and the non-causal one
    (``noncausal_attention_plain``, dense (Tq, Tk) scores)."""

    def __enter__(self):
        from repro_torch.kernels.window_attention import ops
        from repro_torch.models import attention as A

        self.saved = A.sliding_window_attention, A.noncausal_attention
        A.sliding_window_attention = ops.sliding_window_attention_plain
        A.noncausal_attention = ops.noncausal_attention_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A

        A.sliding_window_attention, A.noncausal_attention = self.saved


def softmax_train_cfg(name, n_layers=SOFTMAX_TRAIN_LAYERS, **replace):
    """``name``'s softmax variant (``use_chimera=False``, as the serve paths
    build it; remat "full", the config's default) cut to ``n_layers``."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(name), use_chimera=False, n_layers=n_layers, **replace)


def run_steps(tr, steps):
    """``tr.run(steps)`` between synchronizes with its checkpoints off (at
    full width one save writes ~38 GB of parameters and moments to the
    host); returns ``(out, seconds)``."""
    import torch

    tr.save = lambda blocking=False: None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tr.run(steps)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        del tr.save


def step_vs_plain(phase, label, cfg, plain_route, counted, seed, batch=None):
    """The whole step's loss and gradients, kernel route against plain route
    on the card: ``cfg`` (fp32, full width, 2 layers) at B 1 x STEP_CMP_T,
    or on ``batch`` (numpy arrays) where given, the same weights and batch
    on both.  ``plain_route()`` is the context in which the attention runs
    its plain version; ``counted`` the kernels' launch counters as (module,
    attribute) pairs, which must all move on the kernel route and none on
    the plain one."""
    import torch
    from repro_torch.checkpoint.checkpointer import flatten_with_names
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import global_norm, tree_flatten
    from repro_torch.train import classifier as C
    from repro_torch.train.train_step import value_and_grad

    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    if batch is None:
        batch = TokenStream(vocab_size=cfg.vocab_size, batch_size=1, seq_len=STEP_CMP_T + 1,
                            seed=seed + 1).next_batch()
    shape = " + ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items() if k != "labels")
    batch = C.batch_to_device(batch, "cuda")
    runs = {}
    for route in ("kernel", "plain"):
        before = [getattr(mod, attr) for mod, attr in counted]
        ctx = plain_route() if route == "plain" else contextlib.nullcontext()
        with ctx:
            (loss, metrics), grads = value_and_grad(lambda p: M.loss_fn(cfg, p, batch), params)
        moved = [getattr(mod, attr) - n for (mod, attr), n in zip(counted, before)]
        if not (all(moved) if route == "kernel" else not any(moved)):
            fail(f"{phase} {label}: kernel launches {moved} on the {route} route")
        runs[route] = (loss, metrics, tree_flatten(grads)[0], global_norm(grads))
        del grads
        torch.cuda.empty_cache()
    (lk, mk, gk, nk), (lp, mp, gp, np_) = runs["kernel"], runs["plain"]
    rel = {k: abs(float(a) - float(b)) / abs(float(b))
           for k, a, b in (("loss", lk, lp), ("nll", mk["nll"], mp["nll"]),
                           ("grad_norm", nk, np_))}
    names = flatten_with_names(params)[0]  # tree_flatten's order (sorted keys)
    leaf = [float(torch.linalg.vector_norm(a - b) /
                  torch.clamp(torch.linalg.vector_norm(b), min=1e-30))
            for a, b in zip(gk, gp)]
    worst = max(range(len(leaf)), key=leaf.__getitem__)
    if not all(math.isfinite(float(x)) for x in (lk, lp, nk, np_)):
        fail(f"{phase} {label}: non-finite loss or gradient norm")
    if max(rel.values()) > REF_LOSS_RTOL or leaf[worst] > STEP_GRAD_RTOL:
        fail(f"{phase} {label}: kernel route against plain route: {rel}, worst leaf "
             f"{names[worst]} relative error {leaf[worst]:.3e}")
    log(phase, f"{label}, whole step on {shape}, fp32, {cfg.n_layers} layers at full "
               f"width, kernel route against the plain route on the card: loss {float(lk):.6f} / "
               f"{float(lp):.6f} (relative {rel['loss']:.3e}), nll {rel['nll']:.3e}, gradient "
               f"norm {float(nk):.6f} / {float(np_):.6f} ({rel['grad_norm']:.3e}; tolerance "
               f"{REF_LOSS_RTOL:g}); {len(leaf)} leaves, worst relative gradient error "
               f"{leaf[worst]:.3e} at {names[worst]} (tolerance {STEP_GRAD_RTOL:g}), median "
               f"{sorted(leaf)[len(leaf) // 2]:.3e}; {time.perf_counter() - t0:.1f} s")
    del params, runs, gk, gp
    torch.cuda.empty_cache()
    return {"rel": rel, "leaf_worst": leaf[worst]}


def softmax_step_vs_plain(name):
    """The softmax variant's whole step against the plain route (the window
    cut to STEP_CMP_W where the config has one)."""
    from repro_torch.kernels.window_attention import ops as wops

    cfg = softmax_train_cfg(name, dtype="float32")
    label = f"{name} softmax"
    if cfg.sliding_window:
        cfg = softmax_train_cfg(name, dtype="float32", sliding_window=STEP_CMP_W)
        label += f", window {STEP_CMP_W}"
    return step_vs_plain("train-softmax", label, cfg, plain_window_attention,
                         ((wops, "launches"),), SEED + 90)


def full_width_steps(phase, label, cfg, counted, kernel_key, steps, seq, batch=1, stream=None,
                     profile_seq=None):
    """``cfg`` through the Trainer at B ``batch`` x ``seq`` (launch/train.py's
    build via trainer_for, or over ``stream`` whose batches hold ``batch`` x
    ``seq`` positions; weights drawn on the card, checkpoints off): 1
    warm-up step, ``steps`` timed AdamW steps with the launch counters
    ``counted`` ({name: (module, attribute)}) zeroed just before and read
    just after, then one profiled step (at B ``batch`` x ``profile_seq`` of
    launch/train.py's stream where given: a step of a token loop holds
    hundreds of thousands of host ops, whose trace takes ~13 s to read for
    each second of the step).  Returns the record: the launches,
    ms/step, tokens/s, peak memory, the busy share, the share of kernel time
    of the kernels whose names hold ``kernel_key`` (if given), every step's
    loss and the models' scan scopes (scope_ms) in the profiled step."""
    import tempfile

    import torch
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_flatten

    if cfg.remat != "full":
        fail(f"{phase} {label}: remat {cfg.remat!r}, want the config's default 'full'")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    total = 1 + steps
    with tempfile.TemporaryDirectory(prefix="chimera-full-width-") as tmp:
        tr = trainer_for(cfg, tmp, total + 1, warmup=2, batch=batch, seq=seq, params=params,
                         stream=stream)
        del params
        _, warm_s = run_steps(tr, 1)
        torch.cuda.reset_peak_memory_stats()
        for mod, attr in counted.values():
            setattr(mod, attr, 0)
        out, loop_s = run_steps(tr, total)
        launches = {name: getattr(mod, attr) for name, (mod, attr) in counted.items()}
        peak = torch.cuda.max_memory_allocated()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        if profile_seq:
            from repro_torch.data.pipeline import TokenStream

            tr.stream = TokenStream(vocab_size=cfg.vocab_size, batch_size=batch,
                                    seq_len=profile_seq + 1, seed=SEED)
        t_prof = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            _, prof_s = run_steps(tr, total + 1)
        busy_ms, rows = report_profile(prof, prof_s, f"one {label} training step")
        scopes = scope_ms(prof)
        trace_s = time.perf_counter() - t_prof - prof_s  # the trace's collection and reading
        losses = logged_losses(f"{phase} {label}", out)  # the log holds every step
        del tr, prof
    torch.cuda.empty_cache()
    ms = loop_s / steps * 1e3
    tokens = batch * seq
    kernel_ms = sum(t for key, (t, _) in rows.items() if kernel_key and kernel_key in key)
    share = f"{kernel_ms / busy_ms:.3f}" if busy_ms and kernel_key else "not measured"
    busy = f"{busy_ms / (prof_s * 1e3):.3f}" if busy_ms else "not measured"
    log(phase, f"{label}: {n_params} fp32 parameters drawn on the card in {draw_s:.2f} s; B "
               f"{batch} x {seq}, AdamW (fp32 moments): step 1 {warm_s * 1e3:.1f} ms; steps "
               f"2-{total} {ms:.2f} ms/step, {tokens / (ms / 1e3):.0f} tokens/s; losses "
               f"{[round(x, 5) for x in losses]}; max_memory_allocated {peak} B ({peak - base} "
               f"above the {base} B held before); launches {launches}; profiled step "
               + (f"at B {batch} x {profile_seq} " if profile_seq else "")
               + f"{prof_s * 1e3:.1f} ms (its trace read in {trace_s:.1f} s), busy share {busy}"
               + (f", {kernel_key} kernels {kernel_ms:.1f} ms of it (share of kernel time "
                  f"{share})" if kernel_key else "")
               + "".join(f"; scope {n}: kernels {k:.1f} ms over a span of {sp:.1f} ms ({c} "
                         f"ranges)" for n, (k, sp, c) in scopes.items()))
    if peak >= PEAK_LIMIT:
        fail(f"{phase} {label}: peak memory {peak} B >= {PEAK_LIMIT:.0f}")
    return {"launches": launches, "ms": ms, "tokens_per_s": tokens / (ms / 1e3), "peak": peak,
            "busy": busy, "share": share, "losses": losses, "scopes": scopes}


def train_softmax_full_width(name):
    """(b) / (c): ``name``'s softmax variant at full width, 2 layers,
    through the Trainer (full_width_steps: 1 warm-up + SOFTMAX_TRAIN_STEPS
    timed AdamW steps at B 1 x SOFTMAX_TRAIN_T, one profiled step, the
    window kernels' launches and share); then the whole step against the
    plain route."""
    from repro_torch.kernels.window_attention import ops as wops

    cfg = softmax_train_cfg(name)
    kv, Gq, d, dv = attn_widths(cfg)
    W = cfg.sliding_window or SOFTMAX_TRAIN_T
    label = (f"{name} softmax ({'SWA, window ' + str(W) if cfg.sliding_window else 'full-causal'}"
             f", {cfg.attention_kind}), {cfg.n_layers} layers at full width (d {cfg.d_model}, "
             f"{cfg.n_heads} heads / {kv} kv-heads, d {d}, dv {dv}, vocab {cfg.vocab_size}, "
             f"dtype {cfg.dtype}, remat {cfg.remat})")
    r = full_width_steps("train-softmax", label, cfg,
                         {"all": (wops, "launches"), "bwd": (wops, "bwd_launches")}, "window",
                         SOFTMAX_TRAIN_STEPS, SOFTMAX_TRAIN_T)
    fwd, bwd = r["launches"]["all"] - r["launches"]["bwd"], r["launches"]["bwd"]
    # per layer and step: the forward, its rerun in the backward (remat), and
    # the backward's three launches
    want_fwd, want_bwd = 2 * cfg.n_layers * SOFTMAX_TRAIN_STEPS, 3 * cfg.n_layers * SOFTMAX_TRAIN_STEPS
    if (fwd, bwd) != (want_fwd, want_bwd):
        fail(f"train-softmax {name}: window_attention launches forward {fwd}, backward {bwd}; "
             f"want {want_fwd} and {want_bwd} (layers x steps x (2 forward, 3 backward))")
    cmp = softmax_step_vs_plain(name)
    return {"fwd": fwd, "bwd": bwd, "ms": r["ms"], "tokens_per_s": r["tokens_per_s"],
            "peak": r["peak"], "busy": r["busy"], "window_share": r["share"], "cmp": cmp}


def smoke_card_vs_cpu(phase, label, cfg, counter, steps, stream=None, what="batch 8 x 128"):
    """``cfg`` (a smoke config) through the Trainer, ``steps`` steps on the
    card and on the CPU from the same seeded weights (over ``stream()``'s
    batches where given, else launch/train.py's): losses within
    REF_LOSS_RTOL; the backward counter ``counter`` ((module, attribute))
    must move on the card and not on the CPU (None: a path with no kernel
    of the port)."""
    import tempfile

    mod, attr = counter or (None, None)
    losses = {}
    for dev in ("cuda", "cpu"):
        before = getattr(mod, attr) if mod else 0
        with tempfile.TemporaryDirectory(prefix="chimera-smoke-train-") as tmp:
            tr = trainer_for(cfg, tmp, steps, lr=1e-3, warmup=2, device=dev,
                             stream=stream and stream())
            losses[dev] = logged_losses(f"{phase} smoke {label} {dev}", tr.run())
        if mod and (getattr(mod, attr) > before) != (dev == "cuda"):
            fail(f"{phase} smoke {label}: backward kernel launches on {dev}: "
                 f"{getattr(mod, attr) - before}")
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    if err > REF_LOSS_RTOL:
        fail(f"{phase} smoke {label}: card and CPU losses differ by {err:.3e} > "
             f"{REF_LOSS_RTOL:g}")
    log(phase, f"{label} smoke ({cfg.attention_kind}, d_head {cfg.head_dim}, remat "
               f"{cfg.remat}), {steps} Trainer steps at {what}, card (kernels) vs CPU "
               f"(plain): losses max relative diff {err:.3e} (tolerance {REF_LOSS_RTOL:g}); card "
               f"losses {[round(x, 5) for x in losses['cuda']]}")
    return err


def train_softmax_smoke(name):
    """(d) ``smoke_config(name)``'s softmax variant (Mixtral's window cut to
    SOFTMAX_SMOKE_WINDOW) through the Trainer, SOFTMAX_SMOKE_STEPS steps on
    the card and on the CPU from the same seeded weights: losses within
    REF_LOSS_RTOL."""
    import dataclasses

    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels.window_attention import ops as wops

    cfg = dataclasses.replace(smoke_config(name), use_chimera=False)
    label = f"{name} softmax"
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=SOFTMAX_SMOKE_WINDOW)
        label += f", window {SOFTMAX_SMOKE_WINDOW}"
    return smoke_card_vs_cpu("train-softmax", label, cfg, (wops, "bwd_launches"),
                             SOFTMAX_SMOKE_STEPS)


def phase_train_softmax(recs):
    """Softmax attention trained on the card.  (a) check_window_bwd_kernels;
    (b) Mixtral-8x7B's softmax SWA variant and (c) MiniCPM3-4B's full-causal
    (MLA) variant through the Trainer at full width, 2 layers, B 1 x 8192,
    each with its whole step against the plain route; (d) both smoke
    configs, card against CPU.  The window kernels' counters are zeroed
    just before each main-path run and read just after."""
    check_window_bwd_kernels(recs)
    runs = {name: train_softmax_full_width(name) for name in SOFTMAX_TRAIN}
    for name in SOFTMAX_TRAIN:
        train_softmax_smoke(name)
    launches = {"window_attention": sum(r["fwd"] for r in runs.values()),
                "window_attention_bwd": sum(r["bwd"] for r in runs.values())}
    log("train-softmax", f"launches on the phase's main paths: {launches} ("
                         + ", ".join(f"{n}: forward {r['fwd']}, backward {r['bwd']}"
                                     for n, r in runs.items()) + ")")
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------------
# 15. train-chimera: chimera_attention's backward on the card, and the
#     Chimera variants trained at full width
# --------------------------------------------------------------------------

# the backward kernels (csrc/chimera_attention_bwd.cu) against
# chimera_attention_bwd_plain evaluated in float64 on the same inputs (the
# fp32 ones, or the bf16-rounded ones that a bf16 model passes), so that
# the tolerance measures the kernels' rounding alone: fp32 sums in another
# order, of up to Gq x T terms in the stream tier (dphi_k and dv sum over
# every later chunk's queries), and on the bf16 route the values formed in
# fp32 (P, dS, the state) taken as two bf16 terms each, so each gradient is
# held within
# CHIMERA_BWD_ATOL x its largest entry + CHIMERA_BWD_RTOL x |ref|
CHIMERA_BWD_ATOL, CHIMERA_BWD_RTOL = 1e-5, 1e-4
# the backward's input types: "bfloat16" (all seven: what a bf16 model's
# training step passes, as (b) and (c) log; the bf16 route) and "float32"
# (the fp32 route)
CHIMERA_BWD_DTYPES = ("bfloat16", "float32")
# (b) and (c): the configs' default Chimera variants (m 128, L 256, n_global
# 32) at full width, 2 layers, B 1 x seq 8192, 1 warm-up + 5 timed steps
CHIMERA_TRAIN = ("mixtral-8x7b", "minicpm3-4b")
CHIMERA_TRAIN_LAYERS, CHIMERA_TRAIN_T, CHIMERA_TRAIN_STEPS = 2, 8192, 5
CHIMERA_SMOKE_STEPS = 10  # (d): the smoke configs, card against CPU
# (d, dv, m) of the backward's edge shapes: d = dv at every dv it takes,
# MLA's (96, 64) and its smoke widths (24, 16), d < dv, d % 16 == 8 (40),
# and m off the 64-feature block (16, 48, 144)
CHIMERA_BWD_WIDTHS = ((16, 16, 16), (32, 32, 32), (64, 64, 64), (128, 128, 128), (96, 64, 128),
                      (24, 16, 16), (64, 128, 48), (40, 64, 144))
CHIMERA_BWD_MODES = CHIMERA_MODES[:3]  # (use_local, use_stream): both, local only, stream only
# each route's kernels, as a profiler names them
CHIMERA_BWD_KERNELS = {
    "fp32": ("chimera_bwd_fold", "chimera_bwd_prefix", "chimera_bwd_dkdv", "chimera_bwd_dq"),
    "bf16": ("chimera_bwd_wgmma_fold", "chimera_bwd_wgmma_prefix", "chimera_bwd_wgmma_stream",
             "chimera_bwd_wgmma_dkdv", "chimera_bwd_wgmma_dq"),
}


def chimera_bwd_cost(BH, Gq, T, d, dv, m, L, use_local=True, use_stream=True, esize=(4,) * 7):
    """Bytes and flops of the backward: q, k, v, phi_q, phi_k, g_num and
    g_den read once (``esize`` bytes an element each, in that order) and the
    five gradients written once (fp32); in the local tier five products
    over each chunk's causal pairs (S, dq, dk: 2 d flop a pair; dP, dv: 2
    dv); in the stream tier the state's fold over the keys of chunks ..n-2
    and G's over the queries of chunks 1.. (2 m (dv + 1) flop a row),
    dphi_q over those queries and dphi_k over those keys (the same), dv's
    term (2 m dv).  Returns (bytes, flops, local flops)."""
    n = T // L
    rows, keys = BH * Gq * T, BH * T
    eq, ek, ev, epq, epk, egn, egd = esize
    reads = (rows * (d * eq + dv * egn + m * epq + egd)
             + keys * (d * ek + dv * ev + m * epk))
    writes = 4 * (rows * (d + m) + keys * (d + dv + m))
    local = BH * Gq * n * (L * (L + 1) // 2) * (6 * d + 4 * dv) if use_local else 0
    stream = 0
    if use_stream and n > 1:
        q_rows, k_rows = BH * Gq * (n - 1) * L, BH * (n - 1) * L
        stream = (2 * q_rows + 2 * k_rows) * 2 * m * (dv + 1) + k_rows * 2 * m * dv
    return reads + writes, local + stream, local


def chimera_bwd_inputs(B, Hkv, Gq, T, d, dv, m, seed, dtype="float32"):
    """chimera_inputs and random gradients of the partials, on the card, in
    one of CHIMERA_BWD_DTYPES."""
    import torch

    xs = chimera_inputs(B, Hkv, Gq, T, m, seed, d=d, dv=dv)
    g = torch.Generator().manual_seed(seed + 1000)
    xs = xs + [torch.randn((B, Hkv, Gq, T, dv), generator=g).to("cuda"),
               torch.randn((B, Hkv, Gq, T), generator=g).to("cuda")]
    return [x.to(getattr(torch, dtype)) for x in xs]


def check_chimera_bwd(shape, L, seed, dtype="float32", modes=((True, True),), timed=False,
                      quiet=False, phase="train-chimera"):
    """The backward kernels at ``shape`` = (B, Hkv, Gq, T, d, dv, m) and
    chunk L against chimera_attention_bwd_plain in float64 on the same
    inputs (``dtype`` one of CHIMERA_BWD_DTYPES; "float32" takes the fp32
    route, "bfloat16" the bf16 route, which the route's launch count must
    show) at each (use_local, use_stream) of ``modes``, and a second launch
    bit for bit equal to the first.  ``timed``: the backward, the forward,
    forward + backward, the plain version (float32), the route's kernels'
    split from a profiler trace, against the bound in these types.
    Returns the record."""
    import torch
    from repro_torch.kernels.chimera_attention import ops

    B, Hkv, Gq, T, d, dv, m = shape
    BH = B * Hkv
    xs = chimera_bwd_inputs(B, Hkv, Gq, T, d, dv, m, seed, dtype)
    flat = [x.flatten(0, 1).contiguous() for x in xs]
    route = "fp32" if dtype == "float32" else "bf16"
    counter = f"bwd_launches_{route}"
    label = (f"chimera_attention backward BH {BH} Gq {Gq} T {T} d {d} dv {dv} m {m} L {L} "
             f"{dtype} ({route} route)")
    worst = 0.0
    for use_local, use_stream in modes:
        kw = dict(chunk_size=L, use_local=use_local, use_stream=use_stream)
        before = getattr(ops, counter)
        with torch.no_grad():
            got = ops.chimera_attention_bwd_bh(*flat, **kw)
            again = ops.chimera_attention_bwd_bh(*flat, **kw)
            want = ops.chimera_attention_bwd_plain(*(x.double() for x in xs), L, use_local,
                                                   use_stream)
        per_call = ops.bwd_kernel_launches(T, L, use_stream, use_local, route)
        if getattr(ops, counter) - before != 2 * per_call:
            fail(f"{label} local={use_local} stream={use_stream}: {counter} moved by "
                 f"{getattr(ops, counter) - before}, want 2 x {per_call}")
        for name, a, b, w in zip(("dq", "dk", "dv", "dphi_q", "dphi_k"), got, again, want):
            if a.dtype != torch.float32 or not torch.equal(a, b):
                fail(f"{label} local={use_local} stream={use_stream}: {name} of two launches on "
                     f"the same inputs differ (or dtype {a.dtype})")
            scale = float(w.abs().max())
            worst = max(worst, compare(f"{label} local={use_local} stream={use_stream} {name}",
                                       a, w.reshape(a.shape), atol=CHIMERA_BWD_ATOL * scale,
                                       rtol=CHIMERA_BWD_RTOL) / max(scale, 1e-30))
        del got, again, want
    if not quiet:
        log(phase, f"{label}, (use_local, use_stream) in {list(modes)}: max abs err "
                   f"{worst:.3e} of each gradient's largest entry against the plain version in "
                   f"float64 (tolerance {CHIMERA_BWD_ATOL:g} x max|ref| + {CHIMERA_BWD_RTOL:g} x "
                   f"|ref|); two launches bit for bit equal")
    rec = {"max_abs_err": worst, "shape": f"B {B} x Hkv {Hkv}, Gq {Gq}, T {T}, d {d}, dv {dv}, "
                                          f"m {m}, L {L}, {dtype} ({route} route)",
           "max_abs_err_of": "relative to each gradient's largest entry"}
    if timed:
        with torch.no_grad():
            run = lambda: ops.chimera_attention_bwd_bh(*flat, chunk_size=L)  # noqa: E731
            fwd = lambda: ops.chimera_attention_bh(*flat[:5], chunk_size=L)  # noqa: E731
            ms = event_ms(run, iters=5)
            fwd_ms = event_ms(fwd, iters=5)
            fb_ms = event_ms(lambda: (fwd(), run()), iters=3)
            plain_ms = event_ms(lambda: ops.chimera_attention_bwd_plain(
                *(x.float() for x in xs), L), iters=1)
        split = profiled_kernel_ms(run, CHIMERA_BWD_KERNELS[route], iters=5)
        esize = tuple(x.element_size() for x in xs)
        nbytes, flops, local = chimera_bwd_cost(BH, Gq, T, d, dv, m, L, esize=esize)
        passes, rate = (1, BF16_FLOPS) if route == "bf16" else (TF32_PASSES, TF32_FLOPS)
        bound_ms, bound_by = bound(nbytes, passes * flops, rate)
        fp32_ms = flops / FP32_FLOPS * 1e3
        per_call = ops.bwd_kernel_launches(T, L, route=route)
        rec.update(ms=ms, fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, fp32_cores_ms=fp32_ms, library_ms=None,
                   library_of="none: no PyTorch call computes the partials' gradients",
                   bytes=nbytes, flops=flops, local_flops=local,
                   split={x: t and t[0] for x, t in split.items()})
        kind = ("one bf16 pass on the tensor cores" if route == "bf16"
                else f"x{TF32_PASSES} in TF32 on the tensor cores")
        log(phase, f"{label} device time: backward {ms:.4f} ms ({per_call} launches), forward "
                   f"{fwd_ms:.4f} ms, forward + backward {fb_ms:.4f} ms; plain backward (float32) "
                   f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B; {flops} "
                   f"flop, {local} of them the local tier, {kind}; on the fp32 CUDA cores "
                   f"{fp32_ms:.4f} ms); library call: none; in a profiler trace (ms a launch, "
                   f"launches) " + ", ".join(f"{x} {fmt_ms(t and t[0])} ({t and t[1]})"
                                             for x, t in split.items()))
    del xs, flat
    torch.cuda.empty_cache()
    return rec


def chimera_bwd_shapes():
    """(B, Hkv, Gq, T, d, dv, m) of the backward at Mixtral-8x7B's Chimera
    training shape and at MiniCPM3-4B's MLA Chimera shape (H = Hkv 40)."""
    out = []
    for name in CHIMERA_TRAIN:
        cfg = zoo_chimera(name, CHIMERA_TRAIN_LAYERS)
        kv, Gq, d, dv = attn_widths(cfg)
        out.append((1, kv, Gq, CHIMERA_TRAIN_T, d, dv, cfg.chimera.feature_map.feature_dim(d)))
    return out


SHAPE_KEYS = ("shape", "max_abs_err", "ms", "fwd_ms", "fwd_bwd_ms", "plain_ms", "bound_ms",
              "bound_by", "fp32_cores_ms", "library_ms", "split")


def check_chimera_bwd_kernels(recs):
    """(a) The backward at both training shapes in each of
    CHIMERA_BWD_DTYPES, timed ("bfloat16" the training step's types, the
    bf16 route; "float32" the fp32 route), then at every chunk L of the contract x T in {L, 3L} x
    the three flag pairs x CHIMERA_BWD_WIDTHS (B 2 x Hkv 2, Gq 2) in each
    of them.  Returns the kernels line's record (Mixtral's shape, bf16) with
    the other timings as other shapes."""
    from repro_torch.kernels.chimera_attention import ops

    shapes = list(zip(chimera_bwd_shapes(), (SEED + 110, SEED + 111), (None, MLA_LM)))
    runs = []
    for dtype in CHIMERA_BWD_DTYPES:
        for shape, seed, name in shapes:
            runs.append(check_chimera_bwd(shape, ZOO_L, seed, dtype=dtype, timed=True))
            if name:
                runs[-1]["shape"] = f"{name} Chimera MLA: " + runs[-1]["shape"]
    rec = runs[0]
    rec["other_shapes"] = [{k: o.get(k) for k in SHAPE_KEYS} for o in runs[1:]]
    for dtype in CHIMERA_BWD_DTYPES:
        worst, n, refused = 0.0, 0, []
        for i, (d, dv, m) in enumerate(CHIMERA_BWD_WIDTHS):
            for L in ops.L_TAKEN:
                if ops.contract(d=d, dv=dv, m=m, L=L):  # the forward refuses it: no Function call
                    refused.append((d, dv, m, L))
                    continue
                for T in (L, 3 * L):
                    r = check_chimera_bwd((2, 2, 2, T, d, dv, m), L, SEED + 120 + i + L + T,
                                          dtype=dtype, modes=CHIMERA_BWD_MODES, quiet=True)
                    worst, n = max(worst, r["max_abs_err"]), n + 1
        log("train-chimera", f"chimera_attention backward, {dtype} inputs, at {n} edge shapes (L "
                             f"in {ops.L_TAKEN}, T = L and 3L, (d, dv, m) in "
                             f"{list(CHIMERA_BWD_WIDTHS)}, B 2 x Hkv 2, Gq 2; outside the "
                             f"forward's contract and skipped, (d, dv, m, L) {refused}) x every "
                             f"(use_local, use_stream) of {list(CHIMERA_BWD_MODES)}: max abs "
                             f"err {worst:.3e} of each gradient's largest entry, all within "
                             f"tolerance, every pair of launches bit for bit equal")
    recs["chimera_attention_bwd"] = rec
    return rec


def chimera_step_vs_plain(name):
    """The Chimera variant's whole step against the plain route
    (plain_chimera_kernels: the forward and backward plain a row at a
    time); fp32, so the backward's kernels are the fp32 route's."""
    from repro_torch.kernels.chimera_attention import ops as cops

    return step_vs_plain("train-chimera", f"{name} Chimera",
                         zoo_chimera(name, CHIMERA_TRAIN_LAYERS, dtype="float32"),
                         plain_chimera_kernels, ((cops, "launches"), (cops, "bwd_launches_fp32")),
                         SEED + 92)


class BwdTypes:
    """Within it, the types of the tensors ``names`` that reach a backward
    wrapper (by default the seven of ops.chimera_attention_bwd_bh; or
    ``module``'s function ``fn``), each distinct tuple once."""

    NAMES = ("q", "k", "v", "phi_q", "phi_k", "g_num", "g_den")

    def __init__(self, module=None, fn="chimera_attention_bwd_bh", names=NAMES):
        self.module, self.name, self.NAMES = module, fn, names

    def __enter__(self):
        if self.module is None:
            from repro_torch.kernels.chimera_attention import ops as cops

            self.module = cops
        self.seen, self.fn = [], getattr(self.module, self.name)

        def logged(*args, **kw):
            kinds = tuple(str(t.dtype).replace("torch.", "") for t in args[:len(self.NAMES)])
            if kinds not in self.seen:
                self.seen.append(kinds)
            return self.fn(*args, **kw)

        setattr(self.module, self.name, logged)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def text(self):
        return "; ".join(", ".join(f"{n} {k}" for n, k in zip(self.NAMES, kinds))
                         for kinds in self.seen)


def train_chimera_full_width(name):
    """(b) / (c): ``name``'s Chimera variant at full width, 2 layers,
    through the Trainer (full_width_steps: 1 warm-up + CHIMERA_TRAIN_STEPS
    timed AdamW steps at B 1 x CHIMERA_TRAIN_T, one profiled step); the
    forward kernel launches twice a layer and step (remat), the backward's
    bf16 route bwd_kernel_launches times (the types that reach its wrapper
    are logged); then the whole step against the plain route."""
    from repro_torch.kernels.chimera_attention import ops as cops

    cfg = zoo_chimera(name, CHIMERA_TRAIN_LAYERS)
    if not cfg.use_chimera:
        fail(f"train-chimera {name}: the config's default is not its Chimera variant")
    kv, Gq, d, dv = attn_widths(cfg)
    ch = cfg.chimera
    label = (f"{name} Chimera ({cfg.attention_kind}, m {ch.feature_map.feature_dim(d)}, L "
             f"{ch.chunk_size}, n_global {ch.n_global}), {cfg.n_layers} layers at full width (d "
             f"{cfg.d_model}, {cfg.n_heads} heads / {kv} kv-heads, d {d}, dv {dv}, vocab "
             f"{cfg.vocab_size}, dtype {cfg.dtype}, remat {cfg.remat})")
    with BwdTypes() as types:
        r = full_width_steps("train-chimera", label, cfg,
                             {"fwd": (cops, "launches"), "bwd": (cops, "bwd_launches"),
                              "bwd_bf16": (cops, "bwd_launches_bf16"),
                              "bwd_fp32": (cops, "bwd_launches_fp32")}, "chimera",
                             CHIMERA_TRAIN_STEPS, CHIMERA_TRAIN_T)
    log("train-chimera", f"{name} Chimera: the types that reach chimera_attention_bwd_bh: "
                         f"{types.text()}")
    fwd, bwd = r["launches"]["fwd"], r["launches"]["bwd"]
    per_call = cops.bwd_kernel_launches(CHIMERA_TRAIN_T, ch.chunk_size, route="bf16")
    want_fwd = 2 * cfg.n_layers * CHIMERA_TRAIN_STEPS
    want_bwd = per_call * cfg.n_layers * CHIMERA_TRAIN_STEPS
    if (fwd, bwd, r["launches"]["bwd_bf16"], r["launches"]["bwd_fp32"]) != (
            want_fwd, want_bwd, want_bwd, 0):
        fail(f"train-chimera {name}: chimera_attention launches {r['launches']}; want forward "
             f"{want_fwd} and backward {want_bwd}, all on the bf16 route (layers x steps x (2 "
             f"forward, {per_call} backward))")
    cmp = chimera_step_vs_plain(name)
    return {"fwd": fwd, "bwd": bwd, "ms": r["ms"], "tokens_per_s": r["tokens_per_s"],
            "peak": r["peak"], "busy": r["busy"], "chimera_share": r["share"], "cmp": cmp,
            "types": types.text()}


def train_chimera_smoke(name):
    """(d) ``smoke_config(name)``'s Chimera variant (its default) through
    the Trainer, CHIMERA_SMOKE_STEPS steps on the card and on the CPU from
    the same seeded weights: losses within REF_LOSS_RTOL."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels.chimera_attention import ops as cops

    cfg = smoke_config(name)
    if not cfg.use_chimera:
        fail(f"train-chimera smoke {name}: the smoke config is not the Chimera variant")
    return smoke_card_vs_cpu("train-chimera", f"{name} Chimera", cfg, (cops, "bwd_launches"),
                             CHIMERA_SMOKE_STEPS)


def phase_train_chimera(recs):
    """Chimera attention trained on the card.  (a) check_chimera_bwd_kernels;
    (b) Mixtral-8x7B's Chimera variant and (c) MiniCPM3-4B's Chimera MLA
    variant through the Trainer at full width, 2 layers, B 1 x 8192, each
    with its whole step against the plain route; (d) both smoke configs'
    Chimera variants, card against CPU.  The chimera_attention counters are
    zeroed just before each main-path run and read just after."""
    t0 = time.perf_counter()
    check_chimera_bwd_kernels(recs)
    checks_s = time.perf_counter() - t0
    runs = {name: train_chimera_full_width(name) for name in CHIMERA_TRAIN}
    for name in CHIMERA_TRAIN:
        train_chimera_smoke(name)
    launches = {"chimera_attention": sum(r["fwd"] for r in runs.values()),
                "chimera_attention_bwd": sum(r["bwd"] for r in runs.values())}
    log("train-chimera", f"launches on the phase's main paths: {launches} ("
                         + ", ".join(f"{n}: forward {r['fwd']}, backward {r['bwd']}"
                                     for n, r in runs.items())
                         + f"); the kernel checks of (a) took {checks_s:.1f} s")
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------------
# 18. train-encdec: whisper-tiny trained on the card (the non-causal
#     backward of window_attention_bwd.cu)
# --------------------------------------------------------------------------

# whisper-tiny's train cell (the JAX package's train_4k, cut to one card):
# 4,096 positions split by encoder_seq_fraction 0.5 into Te 2,048 frames and
# T_dec 2,048 tokens (launch/steps.py _enc_dec_split), B 8 of the cell's
# global batch of 256, 1 warm-up + ENCDEC_TRAIN_STEPS timed AdamW steps
ENCDEC_TRAIN_B, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = 8, 4096, 5
# (d): the softmax cross-attention variant's decoder depth
ENCDEC_TRAIN_SOFTMAX_LAYERS = 1
# JAX's smoke criterion (tests/test_models_smoke.py): the last step's loss
# below the first's + LOSS_RISE
LOSS_RISE = 0.5
ENCDEC_SMOKE_STEPS = 5  # (e): smoke whisper-tiny, card against CPU
ENCDEC_SMOKE_SHAPE = (2, 96, 48)  # (e): B, Te, T_dec
# the non-causal backward's names for the types it is handed
NONCAUSAL_BWD_NAMES = ("q", "k", "v", "o", "lse", "do")


def encdec_split(cfg, seq):
    """(Te, T_dec) of ``seq`` positions: the JAX package's _enc_dec_split."""
    te = int(seq * cfg.encoder_seq_fraction)
    return te, seq - te


class EncDecStream:
    """Batches of whisper's train cell for the Trainer, as the JAX Trainer
    takes them: ``enc_embeds`` (B, Te, d) stub frame embeddings from a
    numpy seed and the step, ``tokens`` and ``labels`` (B, T_dec) from
    launch/train.py's TokenStream; resumable (the token stream's state)."""

    def __init__(self, cfg, batch, te, td, seed):
        from repro_torch.data.pipeline import TokenStream

        self.tokens = TokenStream(vocab_size=cfg.vocab_size, batch_size=batch, seq_len=td + 1,
                                  seed=seed)
        self.shape, self.seed = (batch, te, cfg.d_model), seed

    def state(self):
        return self.tokens.state()

    def restore(self, state):
        self.tokens.restore(state)

    def next_batch(self):
        rng = np.random.default_rng((self.seed, self.tokens.step))
        out = self.tokens.next_batch()
        out["enc_embeds"] = rng.standard_normal(self.shape, dtype=np.float32)
        return out


def check_noncausal_bwd(shape, dtype, seed, timed=False, phase="train-encdec", quiet=False):
    """The non-causal backward at ``shape`` = (B, H, Hkv, Tq, Tk, d, dv) in
    ``dtype``: a call that needs a gradient through noncausal_attention (the
    _NonCausalAttention Function: the forward kernel with lse, then the
    backward kernels' non-causal mode, noncausal_bwd_launches up by 3); the
    forward's lse against window_attention_noncausal_lse_plain, and dq, dk,
    dv against window_attention_noncausal_bwd_plain evaluated in float64 on
    the same (rounded) inputs and the kernel's own o and lse, one batch row
    at a time, within check_window_bwd's tolerances; a second backward
    launch bit for bit equal to the first.  ``timed``: the backward alone,
    the forward with lse, forward + backward, the plain version (float32,
    over the batch rows) and scaled_dot_product_attention's backward alone
    (the library column) and forward + backward, against the bound, with
    the three kernels' split from a profiler trace.  ``quiet``: no line of
    its own.  Returns the record."""
    import torch
    from repro_torch.kernels.window_attention import ops

    B, H, Hkv, Tq, Tk, d, dv = shape
    G = H // Hkv
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=g).to("cuda", dt)
                   for s in ((B, H, Tq, d), (B, Hkv, Tk, d), (B, Hkv, Tk, dv), (B, H, Tq, dv)))
    o, lse = ops.window_attention_noncausal_fwd(q, k, v)
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = ops.noncausal_bwd_launches
    out = ops.noncausal_attention(*xs)
    if not torch.equal(out.detach(), o):
        fail(f"window_attention non-causal backward {shape} {dtype}: the Function's forward "
             "differs from the forward kernel's")
    got = torch.autograd.grad(out, xs, do)
    if ops.noncausal_bwd_launches - before != 3:
        fail(f"window_attention non-causal backward {shape} {dtype}: noncausal_bwd_launches "
             f"moved by {ops.noncausal_bwd_launches - before}, want 3")
    del out, xs
    again = ops.window_attention_noncausal_bwd(q, k, v, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if a.dtype != dt or not torch.equal(a, b):
            fail(f"window_attention non-causal backward {shape} {dtype}: {name} of two launches "
                 f"on the same inputs differ (or dtype {a.dtype})")
    del again
    bf16 = dt == torch.bfloat16
    atol, rtol = (WIN_BWD_BF16_ATOL, WIN_BF16_TOL) if bf16 else (WIN_BWD_ATOL, WIN_BWD_RTOL)
    label = (f"window_attention non-causal backward B {B} x H {H} (Hkv {Hkv}) Tq {Tq} Tk {Tk} "
             f"d {d} dv {dv} {dtype}")
    errs = {"lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    with torch.no_grad():
        for b in range(B):
            f = [x[b].double() for x in (q, k, v, o, do)]
            want = ops.window_attention_noncausal_lse_plain(f[0], f[1].repeat_interleave(G, 0))
            errs["lse"] = max(errs["lse"], compare(f"{label} lse b {b}", lse[b].double(), want))
            wants = ops.window_attention_noncausal_bwd_plain(f[0], f[1], f[2], f[3],
                                                             lse[b].double(), f[4])
            # the floor scales with the largest gradient of the row
            scale = max(float(w.abs().max()) for w in wants)
            for name, a, w in zip(("dq", "dk", "dv"), (got[0][b], got[1][b], got[2][b]), wants):
                if bf16:
                    w = w.to(dt)
                e = compare(f"{label} {name} b {b}", a.double(), w.double(),
                            atol=atol * scale, rtol=rtol)
                errs[name] = max(errs[name], e)
            del f, wants
    if not quiet:
        log(phase, f"{label}: max abs err lse {errs['lse']:.3e}, dq {errs['dq']:.3e}, dk "
               f"{errs['dk']:.3e}, dv {errs['dv']:.3e} against the plain version in float64 "
               f"over {B} batch rows (tolerance {atol:g}*max|ref of dq, dk, dv| + "
               f"{rtol:g}*|ref|; lse {ATOL:g} + {RTOL:g}*|ref|); two launches bit for bit equal")
    rec = {"max_abs_err": max(errs[n] for n in ("dq", "dk", "dv")), "errs": errs,
           "shape": f"non-causal, B {B} x H {H} (Hkv {Hkv}) Tq {Tq} Tk {Tk} d {d} dv {dv} "
                    f"{dtype}"}
    if timed:
        with torch.no_grad():
            ms = event_ms(lambda: ops.window_attention_noncausal_bwd(q, k, v, o, lse, do), iters=5)
            fwd_ms = event_ms(lambda: ops.window_attention_noncausal_fwd(q, k, v), iters=5)
            fb_ms = event_ms(lambda: ops.window_attention_noncausal_bwd(
                q, k, v, *ops.window_attention_noncausal_fwd(q, k, v), do), iters=5)
            flat = [x.float().reshape(-1, *x.shape[2:]) for x in (q, k, v, o, do)]
            flse = lse.reshape(-1, Tq)
            rows = [(slice(b * H, (b + 1) * H), slice(b * Hkv, (b + 1) * Hkv)) for b in range(B)]
            plain_ms = event_ms(lambda: [ops.window_attention_noncausal_bwd_plain(
                flat[0][r], flat[1][kr], flat[2][kr], flat[3][r], flse[r], flat[4][r])
                for r, kr in rows], iters=1)
            del flat
        library_ms, lib_fb_ms = sdpa_bwd_ms(q, k, v, do, None)
        nbytes, flops = window_bwd_cost(B, H, Hkv, Tq, None, d, dv, q.element_size(), Tk=Tk)
        fwd_bytes, fwd_flops = noncausal_cost(B, H, Hkv, Tq, Tk, d, dv, q.element_size())
        fwd_bytes += 4 * B * H * Tq  # the lse
        if bf16:
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS)
            fwd_bound_ms, _ = bound(fwd_bytes, fwd_flops, BF16_FLOPS)
            rate = "in bf16 on the tensor cores"
        else:
            bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
            fwd_bound_ms, _ = bound(fwd_bytes, TF32_PASSES * fwd_flops, TF32_FLOPS)
            rate = f"x{TF32_PASSES} in TF32 on the tensor cores"
        split = profiled_kernel_ms(lambda: ops.window_attention_noncausal_bwd(q, k, v, o, lse, do),
                                   WIN_BWD_KERNELS, iters=5)
        rec.update(ms=ms, fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms, library_fwd_bwd_ms=lib_fb_ms,
                   fwd_bound_ms=fwd_bound_ms, bytes=nbytes, flops=flops,
                   fp32_cores_ms=flops / FP32_FLOPS * 1e3,
                   split={x: t and t[0] for x, t in split.items()})
        log(phase, f"{label} device time: backward {ms:.4f} ms (3 launches), forward with lse "
                   f"{fwd_ms:.4f} ms (bound {fwd_bound_ms:.4f} ms), forward + backward "
                   f"{fb_ms:.4f} ms; bound of the backward {bound_ms:.4f} ms by {bound_by} "
                   f"({nbytes} B; {flops} flop, {rate}; on the fp32 CUDA cores "
                   f"{flops / FP32_FLOPS * 1e3:.4f} ms); scaled_dot_product_attention"
                   f"(is_causal=False, PyTorch's choice of backend) backward alone {fmt_ms(library_ms)}, forward + backward "
                   f"{fmt_ms(lib_fb_ms)}; plain backward (float32) {plain_ms:.4f} ms over {B} "
                   f"rows; in a profiler trace (ms a launch, launches) "
                   + ", ".join(f"{x} {fmt_ms(t and t[0])} ({t and t[1]})"
                               for x, t in split.items()))
    del q, k, v, o, lse, do, got
    torch.cuda.empty_cache()
    return rec


NONCAUSAL_BWD_KEYS = ("shape", "max_abs_err", "ms", "fwd_ms", "fwd_bound_ms", "fwd_bwd_ms",
                      "plain_ms", "bound_ms", "bound_by", "library_ms", "library_fwd_bwd_ms",
                      "fp32_cores_ms", "split")


def check_noncausal_bwd_kernels(recs):
    """(a) The non-causal backward at whisper-tiny's encoder training shape
    (B 8 x H 6, Tq = Tk 2,048, d = dv = 64) in bf16 (the training step's
    type) and fp32, each timed, then at every edge shape of the forward
    (NONCAUSAL_EDGES: the serve shape's Tq 256 and Tq 1 against Tk 1,536,
    Tk off the key tile, Tq > Tk, 2 to 4 query heads a kv-head) x every
    (d, dv) of WINDOW_EDGE_DIMS in the edge's own type, and at whisper's
    (64, 64) in the other type too.  The two timed shapes go into
    window_attention_bwd's kernels line as other shapes; the Chimera
    backward at the decoder's training shape (bf16 route, timed) into
    chimera_attention_bwd's."""
    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC)
    te, _ = encdec_split(cfg, ENCDEC_TRAIN_SEQ)
    shape = (ENCDEC_TRAIN_B, cfg.n_heads, cfg.n_kv_heads, te, te, cfg.head_dim, cfg.head_dim)
    runs = [check_noncausal_bwd(shape, dtype, SEED + 130 + i, timed=True)
            for i, dtype in enumerate(("bfloat16", "float32"))]
    for r in runs:
        r["shape"] = "whisper-tiny encoder training, " + r["shape"]
        recs["window_attention_bwd"].setdefault("other_shapes", []).append(
            {k: r.get(k) for k in NONCAUSAL_BWD_KEYS})
    # the decoder's Chimera self-attention: its backward at whisper's shape (BH 48,
    # Gq 1, T_dec 2,048 in chunks of L 256), in the step's types (the bf16 route)
    _, td = encdec_split(cfg, ENCDEC_TRAIN_SEQ)
    kv, Gq, d, dv = attn_widths(cfg)
    ch = check_chimera_bwd((ENCDEC_TRAIN_B, kv, Gq, td, d, dv,
                            cfg.chimera.feature_map.feature_dim(d)), cfg.chimera.chunk_size,
                           SEED + 135, dtype="bfloat16", timed=True, phase="train-encdec")
    ch["shape"] = "whisper-tiny decoder training: " + ch["shape"]
    recs.setdefault("chimera_attention_bwd", {}).setdefault("other_shapes", []).append(
        {k: ch.get(k) for k in SHAPE_KEYS})
    worst, n = {"float32": 0.0, "bfloat16": 0.0}, 0
    for i, (Tq, Tk, own, H, Hkv) in enumerate(NONCAUSAL_EDGES):
        other = "float32" if own == "bfloat16" else "bfloat16"
        for (d, dv), dtype in [(dims, own) for dims in WINDOW_EDGE_DIMS] + [((64, 64), other)]:
            r = check_noncausal_bwd((2, H, Hkv, Tq, Tk, d, dv), dtype, SEED + 140 + i, quiet=True)
            worst[dtype], n = max(worst[dtype], r["max_abs_err"]), n + 1
    log("train-encdec", f"window_attention non-causal backward at {len(NONCAUSAL_EDGES)} edge "
                        f"shapes x {len(WINDOW_EDGE_DIMS)} (d, dv) in the edge's type, and at (64, "
                        f"64) in the other ({n} checks): max abs err fp32 "
                        f"{worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}, all within "
                        f"tolerance, every pair of launches bit for bit equal")
    return runs


@contextlib.contextmanager
def plain_attention_kernels():
    """Within the block every attention kernel of the model runs its plain
    version on the card: the window wrappers (plain_window_attention) and
    the Chimera ones (plain_chimera_kernels)."""
    with plain_window_attention(), plain_chimera_kernels():
        yield


def encdec_train_launches(cfg, steps):
    """The kernels' launches that ``steps`` training steps of ``cfg`` (remat
    "full": a layer's forward runs twice) make at ENCDEC_TRAIN_SEQ, by
    counter: the encoder's non-causal self-attention in every layer; the
    decoder's Chimera self-attention (its bf16 backward route), or its
    full-causal softmax and non-causal softmax cross-attention."""
    from repro_torch.kernels.chimera_attention import ops as cops

    _, td = encdec_split(cfg, ENCDEC_TRAIN_SEQ)
    nc = cfg.encoder_layers + (0 if cfg.use_chimera else cfg.n_layers)  # non-causal layers
    causal = 0 if cfg.use_chimera else cfg.n_layers
    chim = cfg.n_layers if cfg.use_chimera else 0
    want = {"noncausal": 2 * nc, "noncausal_bwd": 3 * nc, "bwd": 3 * (nc + causal),
            "window": 5 * (nc + causal), "chimera": 2 * chim,
            "chimera_bwd": chim * cops.bwd_kernel_launches(td, cfg.chimera.chunk_size,
                                                           route="bf16")}
    want["chimera_bwd_bf16"] = want["chimera_bwd"]
    return {k: n * steps for k, n in want.items()}


def train_encdec_full(label, cfg):
    """(b) ``cfg`` at full width through the Trainer on whisper's train cell
    (full_width_steps over an EncDecStream: B 8 x Te 2,048 frames + T_dec
    2,048 tokens, bf16, remat "full"), the kernels' launches held to
    encdec_train_launches, the types reaching the non-causal backward logged,
    the loss finite and its last step below the first's + LOSS_RISE; (c) the
    whole step against the plain route on the card in float32 on one batch of
    the same size."""
    import dataclasses

    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.window_attention import ops as wops

    te, td = encdec_split(cfg, ENCDEC_TRAIN_SEQ)
    counted = {"window": (wops, "launches"), "bwd": (wops, "bwd_launches"),
               "noncausal": (wops, "noncausal_launches"),
               "noncausal_bwd": (wops, "noncausal_bwd_launches"), "chimera": (cops, "launches"),
               "chimera_bwd": (cops, "bwd_launches"),
               "chimera_bwd_bf16": (cops, "bwd_launches_bf16")}
    stream = EncDecStream(cfg, ENCDEC_TRAIN_B, te, td, SEED + 150)
    with BwdTypes(wops, "window_attention_noncausal_bwd", NONCAUSAL_BWD_NAMES) as types:
        r = full_width_steps("train-encdec", label, cfg, counted, "window", ENCDEC_TRAIN_STEPS,
                             ENCDEC_TRAIN_SEQ, batch=ENCDEC_TRAIN_B, stream=stream)
    log("train-encdec", f"{label}: the types that reach window_attention_noncausal_bwd: "
                        f"{types.text()}")
    want = encdec_train_launches(cfg, ENCDEC_TRAIN_STEPS)
    if r["launches"] != want:
        fail(f"train-encdec {label}: launches {r['launches']}, want {want}")
    if not r["losses"][-1] < r["losses"][0] + LOSS_RISE:
        fail(f"train-encdec {label}: last loss {r['losses'][-1]} not below the first's "
             f"{r['losses'][0]} + {LOSS_RISE}")
    f32 = dataclasses.replace(cfg, dtype="float32")
    counters = ((wops, "noncausal_bwd_launches"),
                (cops, "bwd_launches_fp32") if cfg.use_chimera else (wops, "bwd_launches"))
    r["cmp"] = step_vs_plain("train-encdec", label, f32, plain_attention_kernels, counters,
                             SEED + 151, batch=EncDecStream(f32, ENCDEC_TRAIN_B, te, td,
                                                            SEED + 152).next_batch())
    return r


def encdec_smoke_stream(cfg):
    B, te, td = ENCDEC_SMOKE_SHAPE
    return lambda: EncDecStream(cfg, B, te, td, SEED + 153)


def phase_train_encdec(recs):
    """whisper-tiny trained on the card.  (a) check_noncausal_bwd_kernels;
    (b), (c) train_encdec_full at full width and depth (4 + 4 layers, d
    384), then (d) both for the softmax cross-attention variant at
    ENCDEC_TRAIN_SOFTMAX_LAYERS decoder layer; (e) smoke whisper-tiny, both
    branches, ENCDEC_SMOKE_STEPS Trainer steps card against CPU in fp32.
    The counters are zeroed just before each main-path run and read just
    after."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels.window_attention import ops as wops

    t0 = time.perf_counter()
    check_noncausal_bwd_kernels(recs)
    seconds = {"kernels": time.perf_counter() - t0}
    cfg = get_config(ENCDEC)
    runs = {}
    for label, c in (("whisper-tiny", cfg),
                     (f"whisper-tiny softmax cross-attention, {ENCDEC_TRAIN_SOFTMAX_LAYERS} "
                      f"decoder layer", dataclasses.replace(
                          cfg, use_chimera=False, n_layers=ENCDEC_TRAIN_SOFTMAX_LAYERS))):
        t0 = time.perf_counter()
        runs[label] = train_encdec_full(label, c)
        seconds[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    B, te, td = ENCDEC_SMOKE_SHAPE
    for use_chimera in (True, False):
        c = dataclasses.replace(smoke_config(ENCDEC), use_chimera=use_chimera)
        smoke_card_vs_cpu("train-encdec", f"{ENCDEC} {'Chimera' if use_chimera else 'softmax'}",
                          c, (wops, "noncausal_bwd_launches"), ENCDEC_SMOKE_STEPS,
                          stream=encdec_smoke_stream(c),
                          what=f"batch {B} x (Te {te} frames + T_dec {td} tokens)")
    seconds["smoke"] = time.perf_counter() - t0
    launches = {"window_attention": 0, "window_attention_bwd": 0, "chimera_attention": 0,
                "chimera_attention_bwd": 0}
    for r in runs.values():
        n = r["launches"]
        launches["window_attention"] += n["window"] - n["bwd"]
        launches["window_attention_bwd"] += n["bwd"]
        launches["chimera_attention"] += n["chimera"]
        launches["chimera_attention_bwd"] += n["chimera_bwd"]
    log("train-encdec", f"launches on the phase's main paths: {launches}; seconds by part: "
                        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------------
# 19. train-ssm: Mamba and xLSTM trained on the card
# --------------------------------------------------------------------------

# Jamba's training cut (jamba_train_cut) at B 1 x SSM_TRAIN_T, 1 warm-up +
# SSM_TRAIN_STEPS timed steps, the profiled step at B 1 x SSM_PROFILE_T.
# xLSTM-125M at full depth at B 4 x XLSTM_TRAIN_T (two mLSTM chunks of 256,
# so the checkpointed chunk carries its state across a boundary at full
# width), 1 + XLSTM_TRAIN_STEPS steps, profiled at B 4 x XLSTM_PROFILE_T.
# Cut for the run's time (PERF.md section 4): on an H100 80GB HBM3 at 700 W
# a Jamba step at 8,192 took 2.88-3.13 s and its profiled trace 44.1 s to
# read (9.2 s at 1,024); xLSTM at B 4 x 512 7.34 s a step and its trace
# 187.7 s (12.7 s at B 4 x 32: token loops of host-bound launches)
SSM_TRAIN_T, SSM_TRAIN_STEPS, SSM_PROFILE_T = 4096, 2, 512
XLSTM_TRAIN_B, XLSTM_TRAIN_T, XLSTM_TRAIN_STEPS, XLSTM_PROFILE_T = 4, 512, 1, 16
SSM_SMOKE_STEPS, SSM_SMOKE_T = 3, 64  # the smoke configs, card against CPU, at B 8 x 64


def jamba_train_cut():
    """Jamba-1.5-Large's training cut: 2 of its 72 layers at full width,
    pattern (Mamba, attention), both with the dense MLP of Jamba's odd
    positions (moe_first_dense 2): ~2.85 G parameters, ~46 GB of fp32
    parameters, gradients and moments (jamba_cut's MoE layer alone, 16
    experts of 3 x 8192 x 24576, would be 9.66 G parameters, 155 GB of
    AdamW state)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SSM_JAMBA), n_layers=2, block_pattern=("mamba", "attn"),
                               moe_first_dense=2)


def phase_train_ssm(recs):
    """Mamba and xLSTM trained on the card, each config through
    launch/train.py's build (full_width_steps): (a) Jamba's training cut at B
    1 x SSM_TRAIN_T, its Chimera attention's backward at Gq 8 on the bf16
    route (the types logged), then its whole step against the plain route
    in float32 at STEP_CMP_T; (b) xLSTM-125M at full depth, B 4 x
    XLSTM_TRAIN_T; each
    with ms/step, tokens/s, peak memory, busy share and the "mamba",
    "mlstm" and "slstm" scopes' kernel and span times, the loss finite and
    its last step below the first's + LOSS_RISE; (c) both smoke configs,
    SSM_SMOKE_STEPS Trainer steps card against CPU in fp32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.chimera_attention import ops as cops

    seconds, runs = {}, {}
    t0 = time.perf_counter()
    cfg = jamba_train_cut()
    kv, Gq, d, dv = attn_widths(cfg)
    label = (f"{SSM_JAMBA} training cut (mamba + attn, dense MLPs, Chimera Gq {Gq} d {d}), "
             f"{cfg.n_layers} layers at full width (d {cfg.d_model}, dtype {cfg.dtype}, remat "
             f"{cfg.remat})")
    counted = {"fwd": (cops, "launches"), "bwd": (cops, "bwd_launches"),
               "bwd_bf16": (cops, "bwd_launches_bf16")}
    with BwdTypes() as types:
        r = full_width_steps("train-ssm", label, cfg, counted, "chimera", SSM_TRAIN_STEPS,
                             SSM_TRAIN_T, profile_seq=SSM_PROFILE_T)
    log("train-ssm", f"{SSM_JAMBA}: the types that reach chimera_attention_bwd_bh: "
                     f"{types.text()}")
    per_call = cops.bwd_kernel_launches(SSM_TRAIN_T, cfg.chimera.chunk_size, route="bf16")
    n_attn = cfg.pattern.count("attn") * cfg.n_groups
    want = {"fwd": 2 * n_attn * SSM_TRAIN_STEPS, "bwd": per_call * n_attn * SSM_TRAIN_STEPS}
    want["bwd_bf16"] = want["bwd"]
    if r["launches"] != want:
        fail(f"train-ssm {SSM_JAMBA}: chimera_attention launches {r['launches']}, want {want}")
    r["cmp"] = step_vs_plain("train-ssm", f"{SSM_JAMBA} training cut",
                             dataclasses.replace(cfg, dtype="float32"), plain_chimera_kernels,
                             ((cops, "launches"), (cops, "bwd_launches_fp32")), SEED + 160)
    runs[SSM_JAMBA] = r
    seconds[SSM_JAMBA] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = get_config(SSM_XLSTM)
    runs[SSM_XLSTM] = full_width_steps(
        "train-ssm", f"{SSM_XLSTM} at full depth ({x.n_layers} layers, pattern {x.pattern}, d "
                     f"{x.d_model}, mLSTM chunk {x.chimera.chunk_size}, dtype {x.dtype})", x, {},
        None, XLSTM_TRAIN_STEPS, XLSTM_TRAIN_T, batch=XLSTM_TRAIN_B, profile_seq=XLSTM_PROFILE_T)
    seconds[SSM_XLSTM] = time.perf_counter() - t0
    scopes = {SSM_JAMBA: ("mamba",), SSM_XLSTM: ("mlstm", "slstm")}
    for name, rr in runs.items():
        if not rr["losses"][-1] < rr["losses"][0] + LOSS_RISE:
            fail(f"train-ssm {name}: last loss {rr['losses'][-1]} not below the first's "
                 f"{rr['losses'][0]} + {LOSS_RISE}")
        missing = [sc for sc in scopes[name] if sc not in rr["scopes"]]
        if missing:
            log("train-ssm", f"{name}: scopes {missing} not measured (not in the profiled "
                             f"step's trace)")
    t0 = time.perf_counter()
    for name, counter in ((SSM_JAMBA, (cops, "bwd_launches")), (SSM_XLSTM, None)):
        c = smoke_config(name)
        smoke_card_vs_cpu("train-ssm", name, c, counter, SSM_SMOKE_STEPS,
                          stream=lambda c=c: TokenStream(vocab_size=c.vocab_size, batch_size=8,
                                                         seq_len=SSM_SMOKE_T + 1, seed=SEED),
                          what=f"batch 8 x {SSM_SMOKE_T}")
    seconds["smoke"] = time.perf_counter() - t0
    launches = {"chimera_attention": r["launches"]["fwd"],
                "chimera_attention_bwd": r["launches"]["bwd"]}
    log("train-ssm", f"launches on the phase's main paths: {launches}; seconds by part: "
                     + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"launches": launches, "runs": runs}


# --------------------------------------------------------------------------
# 7. reference: the card against the plain versions on the CPU
# --------------------------------------------------------------------------

# the engine phases card against CPU run REFERENCE_LAYERS of the paper
# model's 4 layers: the CPU engines' host time grows with the layers (each
# layer is the same code), and 2 keep the whole run within its time: on
# an H100 80GB HBM3 at 700 W the reference phases took 33.0 s at 2 layers
# in a whole run of 899.0 s on a slow host, 9.8 s at 1 in a run of 627.3 s
# on a fast one
REFERENCE_LAYERS = 2
# card vs CPU, fp32 on both sides with other summation orders, through the
# layers and up to 3 x 16 decode steps per flow.  Without the static-global
# tier every float agrees within 2e-4.  With it, a sign-LSH bit
# (x . proj > 0) of a query whose dot product is within rounding of 0 can
# flip between the two, which moves one global key across the Hamming
# threshold for one token and head: decisions stay identical, scores may
# move by up to 1e-2.
REFERENCE_TOL = {0: 2e-4, 64: 1e-2}


REF_PRED_MARGIN = 1e-4  # pred is held wherever the top-2 logit margin exceeds it
FLOATS = ("trust", "s_nn", "s_sym")


def hold_outputs(what, got, want, tol, margins=None):
    """Decisions identical (veto bits, signatures, trust 1.0 on every veto),
    pred wherever the top-2 margins, where given, exceed REF_PRED_MARGIN, the
    floats within ``tol``; returns the floats' max abs differences."""
    for k in ("vetoed", "sig"):
        if not (got[k] == want[k]).all():
            fail(f"{what}: {k} differs")
    if not (got["trust"][got["vetoed"]] == 1.0).all():
        fail(f"{what}: a vetoed packet has trust != 1.0")
    if margins is not None and not (got["pred"] == want["pred"])[margins > REF_PRED_MARGIN].all():
        fail(f"{what}: pred differs where the top-2 margin exceeds {REF_PRED_MARGIN:g}")
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in FLOATS}
    for k, e in errs.items():
        if e > tol:
            fail(f"{what}: {k} differs by {e:.3e} > {tol:g}")
    return errs


def phase_reference(n_global):
    """The engine at the paper's width, REFERENCE_LAYERS of its layers, on a
    small table (capacity 24, lanes 16, idle_timeout 2),
    3 rule-violating batches through five engines: per-round on the card
    and on the CPU, fused on the card (graphs) and on the CPU (eager), and
    fused on the card run eagerly (the same step without graphs).  Held: the
    card's per-round engine to the CPU's, the card's fused engine to the
    card's per-round engine and to the CPU's fused engine, and its graph
    replays to the eager step (expected bit-identical)."""
    import dataclasses

    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.flow_ingest import fused as fmod
    from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig, make_fused_ingest
    from repro_torch.train import classifier as C

    ccfg, params = paper_classifier(n_global, n_layers=REFERENCE_LAYERS)
    sc = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=48, seed=SEED + 1)
    batches = [sc.next_batch() for _ in range(3)]
    rules = C.default_rules(ccfg, sc.anomaly_signature)
    fcfg = FlowEngineConfig(capacity=24, lanes=16, state_budget_bytes=1 << 40, idle_timeout=2)
    ffcfg = dataclasses.replace(fcfg, fused=True)
    eng = {
        "card": FlowEngine(ccfg, params, rules, fcfg, device="cuda"),
        "cpu": FlowEngine(ccfg, params, rules, fcfg, device="cpu"),
        "card fused": FlowEngine(ccfg, params, rules, ffcfg, device="cuda"),
        "cpu fused": FlowEngine(ccfg, params, rules, ffcfg, device="cpu"),
        "card fused eager": FlowEngine(ccfg, params, rules, ffcfg, device="cuda"),
    }
    # the twin runs the fused step eagerly on the card: only to hold the
    # graphs against it (the engine itself never does)
    twin = eng["card fused eager"]
    twin._graphs = None
    twin._fused_eager = make_fused_ingest(ccfg, twin._n_slots, score_fn=fmod.make_score_fn(ccfg))
    # the per-round card engine's class logits, per packet, for the margin rule
    margins = RoundMargins(eng["card"])
    tol = REFERENCE_TOL[n_global]
    pairs = (("card", "cpu"), ("card fused", "card"), ("card fused", "cpu fused"),
             ("card fused", "card fused eager"))
    worst = {p: {k: 0.0 for k in FLOATS} for p in pairs}
    bit_equal = True  # graph replays against the eager step
    vetoed = 0
    for b in batches:
        with margins:
            outs = {"card": eng["card"].ingest(b["flow_ids"], b["tokens"])}
        mg = margins.margins()
        outs.update({name: e.ingest(b["flow_ids"], b["tokens"]) for name, e in eng.items()
                     if name != "card"})
        for got, want in pairs:
            errs = hold_outputs(f"reference n_global={n_global}: {got} vs {want}",
                                outs[got], outs[want], tol, mg)
            worst[got, want] = {k: max(worst[got, want][k], errs[k]) for k in FLOATS}
        g, e = outs["card fused"], outs["card fused eager"]
        bit_equal &= all((g[k] == e[k]).all() for k in ("pred",) + FLOATS)
        vetoed += int(outs["card"]["vetoed"].sum())
    for name, e in eng.items():
        if e.stats != eng["cpu"].stats:
            fail(f"reference: {name} stats {e.stats} differ from the CPU's {eng['cpu'].stats}")
        if e.table.slot_of != eng["cpu"].table.slot_of:
            fail(f"reference: {name} slot assignments differ from the CPU's")
    g, e = eng["card fused"], twin
    cap = fcfg.capacity
    for name in ("positions", "sig", "hidden_sum", "vetoed"):
        bit_equal &= bool((getattr(g, name)[:cap] == getattr(e, name)[:cap]).all())
    log("reference", f"n_global={n_global}: 3 rule-violating batches, decisions identical "
                     f"across all five engines ({vetoed} vetoes; pred wherever the top-2 margin "
                     f"exceeds {REF_PRED_MARGIN:g}), stats and slots identical; max diffs "
                     + "; ".join(f"{a} vs {b}: " + ", ".join(f"{k} {v:.3e}" for k, v in w.items())
                                 for (a, b), w in worst.items())
                     + f" (tolerance {tol:g}); graph replays vs the eager step on the card: "
                     + ("bit-identical (outputs and table)" if bit_equal else
                        "not bit-identical, held to the tolerance above")
                     + f"; stats {eng['card'].stats}")


# card vs CPU training, 3 AdamW steps of a small model: fp32 on both sides
# with other summation orders, so losses agree within REF_LOSS_RTOL.  Step 1
# of Adam moves a parameter by lr * g / |g|, so an entry whose gradient is
# within rounding of 0 can move by up to 2 * lr per step in opposite
# directions on the two sides: every entry must stay within 2 * sum(lr),
# and all but REF_PARAM_SHARE of them within REF_PARAM_ATOL.
REF_LOSS_RTOL = 1e-4
REF_PARAM_ATOL, REF_PARAM_SHARE = 1e-5, 1e-3
REF_STEPS, REF_LR = 3, 3e-3


def small_classifier(device):
    """A 2-layer model of the paper's family at shapes the kernel takes
    (d_head 64, m 64, L 32), with a static-global set."""
    import dataclasses

    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.train import classifier as C

    ch = ARCH.chimera
    arch = dataclasses.replace(
        ARCH, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_head=64, d_ff=256,
        vocab_size=512,
        chimera=dataclasses.replace(ch, feature_map=dataclasses.replace(ch.feature_map, m=64),
                                    chunk_size=32, n_global=16, sig_bits=32, match_hamming=12),
    )
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256, sig_words=8)
    return ccfg, C.init_classifier(ccfg, torch.Generator().manual_seed(SEED + 3), device)


def phase_reference_train():
    import torch
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.optim.optimizer import AdamWConfig, schedule, tree_flatten, tree_map
    from repro_torch.train import classifier as C

    ccfg, params = small_classifier("cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        before = cops.launches
        p = tree_map(lambda t: t.to(dev), params)
        out, _, losses = C.train_classifier(ccfg, packet_stream(SEED + 2, batch=16, seq=128), p,
                                            steps=REF_STEPS, lr=REF_LR)
        if (cops.launches > before) != (dev == "cuda"):
            fail(f"reference train: chimera_attention launches on {dev}: {cops.launches - before}")
        runs[dev] = (check_losses(f"reference train {dev}", losses),
                     [t.detach().cpu() for t in tree_flatten(out)[0]])
    (lg, pg), (lc, pc) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    if loss_err > REF_LOSS_RTOL:
        fail(f"reference train: losses differ by {loss_err:.3e} (relative) > {REF_LOSS_RTOL:g}: "
             f"{lg} vs {lc}")
    ocfg = AdamWConfig(lr=REF_LR, warmup_steps=3, total_steps=REF_STEPS)
    lr_sum = sum(float(schedule(ocfg, torch.tensor(i))) for i in range(1, REF_STEPS + 1))
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
    share = float((diffs > REF_PARAM_ATOL).float().mean())
    if float(diffs.max()) > 2 * lr_sum or share > REF_PARAM_SHARE:
        fail(f"reference train: params differ: max {float(diffs.max()):.3e} (limit "
             f"{2 * lr_sum:.3e}), share beyond {REF_PARAM_ATOL:g} {share:.3e} "
             f"(limit {REF_PARAM_SHARE:g})")
    log("reference", f"train: {REF_STEPS} classifier steps of a small model (2 layers, d 128, "
                     f"d_head 64, m 64, L 32, n_global 16; batch 16 x 128), card (kernel) vs CPU "
                     f"(plain): losses {lg} vs {lc}, max relative diff {loss_err:.3e} (tolerance "
                     f"{REF_LOSS_RTOL:g}); {diffs.numel()} parameters, max abs diff "
                     f"{float(diffs.max()):.3e} (limit {2 * lr_sum:.3e}), share beyond "
                     f"{REF_PARAM_ATOL:g}: {share:.3e} (limit {REF_PARAM_SHARE:g})")


# card vs CPU serving of a small softmax-SWA MoE model (fp32 on both sides,
# drop-free capacity): greedy generations identical, and the next-token
# logits after the prompts within REF_LOGIT_TOL (abs, + the same relative)
# of each other: O(1) logits through 2 layers in other summation orders.
REF_LOGIT_TOL = 1e-4
REF_SERVE_PROMPTS, REF_SERVE_NEW, REF_SERVE_MAX_LEN = (150, 130, 170), 8, 256


def phase_reference_serve():
    import torch
    from repro_torch.kernels.window_attention import ops as wops
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.serve.engine import Request, ServeEngine

    # 2 layers, d 256, head_dim 64 (a width the kernel takes), window 48 below
    # the prompts (ring wrap), 4 experts top-2 with capacity factor 4 (no drops)
    cfg = mixtral_softmax(2, d_model=256, n_heads=4, n_kv_heads=2, d_head=64, d_ff=512,
                          vocab_size=512, vocab_pad_multiple=32, sliding_window=48,
                          moe_experts=4, moe_d_ff=256, capacity_factor=4.0, dtype="float32")
    params = M.init_model(cfg, torch.Generator().manual_seed(SEED + 40), device="cpu")
    rng = np.random.default_rng(SEED + 41)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in REF_SERVE_PROMPTS]
    common = min(REF_SERVE_PROMPTS)
    runs = {}
    for dev in ("cuda", "cpu"):
        before = wops.launches
        p = tree_map(lambda t: t.to(dev), params)
        engine = ServeEngine(cfg, p, batch_slots=4, max_len=REF_SERVE_MAX_LEN, device=dev)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=REF_SERVE_NEW)
                for i, pr in enumerate(prompts)]
        engine.prefill_batch(reqs)
        engine.run_until_done()
        with torch.no_grad():
            logits, _ = M.prefill_with_caches(
                cfg, p, torch.tensor([pr[:common] for pr in prompts], device=dev),
                max_len=REF_SERVE_MAX_LEN)
        if (wops.launches > before) != (dev == "cuda"):
            fail(f"reference serve: window_attention launches on {dev}: "
                 f"{wops.launches - before}")
        runs[dev] = ([r.generated for r in reqs], logits.cpu())
    (gen_g, lg), (gen_c, lc) = runs["cuda"], runs["cpu"]
    if gen_g != gen_c:
        fail(f"reference serve: greedy generations differ: card {gen_g} vs CPU {gen_c}")
    err = compare("reference serve logits", lg, lc, atol=REF_LOGIT_TOL, rtol=REF_LOGIT_TOL)
    log("reference", f"serve: a small softmax-SWA MoE model (2 layers, d 256, head_dim 64, "
                     f"window 48, 4 experts top-2, capacity factor 4), prompts of "
                     f"{list(REF_SERVE_PROMPTS)} tokens, prefill_batch then {REF_SERVE_NEW} "
                     f"greedy tokens each: card (kernel) and CPU (plain) generations identical "
                     f"{gen_g}; next-token logits after {common} tokens max abs diff {err:.3e} "
                     f"(tolerance {REF_LOGIT_TOL:g} + {REF_LOGIT_TOL:g}*|ref|)")


def phase_smoke_configs():
    """The smoke configs on the card against the same calls on the CPU, at
    the widths the kernels' contracts were widened for (d_head 16, m 16,
    L 16): ``smoke_config("chimera-dataplane")`` through ``FlowEngine.ingest``
    (per-round and fused) and ``loss_fn`` with its backward; the softmax
    variant of ``smoke_config("mixtral-8x7b")`` through
    ``ServeEngine.prefill_batch`` and 4 greedy decode ticks, and ``loss_fn``
    forward (train-softmax trains it); smoke
    whisper-tiny (``smoke_encdec``).  The Chimera
    smoke's vocabulary is widened to 512 so that FlowScenario's marker
    tokens (256..511) embed, as the test suite's tiny model does; no kernel
    width changes with it."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.flow_ingest import fused as fmod
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_flatten, tree_map
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig
    from repro_torch.train import classifier as C
    from repro_torch.train.train_step import value_and_grad

    kernels = ("decode_step", "flow_score", "chimera_attention", "window_attention")
    before = {name: fmod.COUNTED[name].launches for name in kernels}
    rng = np.random.default_rng(SEED + 53)

    # chimera-dataplane: the flow engine, per-round and fused
    arch = dataclasses.replace(smoke_config("chimera-dataplane"), vocab_size=512)
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256, sig_words=8)
    params = C.init_classifier(ccfg, torch.Generator().manual_seed(SEED + 50), device="cpu")
    sc = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=48,
                      seed=SEED + 51)
    batches = [sc.next_batch() for _ in range(3)]
    fcfg = dict(capacity=24, lanes=16, state_budget_bytes=1 << 40, idle_timeout=2)
    tol = REFERENCE_TOL[64]  # a static-global tier (n_global 8)
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        rules = C.default_rules(ccfg, sc.anomaly_signature, device=dev)
        for fused in (False, True):
            e = FlowEngine(ccfg, p, rules, FlowEngineConfig(fused=fused, **fcfg), device=dev)
            runs[dev, fused] = ([e.ingest(b["flow_ids"], b["tokens"]) for b in batches], e)
    worst = {k: 0.0 for k in FLOATS}
    for (dev, fused), (outs, e) in runs.items():
        want_outs, want = runs["cpu", False]
        if e.stats != want.stats or e.table.slot_of != want.table.slot_of:
            fail(f"smoke chimera-dataplane {dev} fused={fused}: stats or slots differ")
        for got_b, want_b in zip(outs, want_outs):
            errs = hold_outputs(f"smoke chimera-dataplane {dev} fused={fused} vs cpu per-round",
                                got_b, want_b, tol)
            worst = {k: max(worst[k], errs[k]) for k in FLOATS}
    vetoes = sum(int(o["vetoed"].sum()) for o in runs["cuda", True][0])
    log("smoke", f"chimera-dataplane smoke (d_head 16, m 16, L 16, n_global 8): FlowEngine "
                 f"per-round and fused (graphs at widths "
                 f"{sorted(w for w, _ in runs['cuda', True][1].fused_graphs())}) on the card vs "
                 f"the CPU, 3 rule-violating batches: veto bits and signatures identical "
                 f"({vetoes} vetoes), max "
                 f"diffs " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                 + f" (tolerance {tol:g})")

    # chimera-dataplane: loss_fn and its gradients
    toks = rng.integers(0, arch.vocab_size, (2, 65))
    got = {}
    for dev in ("cuda", "cpu"):
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        bp = tree_map(lambda t: t.to(dev), params["backbone"])
        (loss, _), grads = value_and_grad(lambda q: M.loss_fn(arch, q, batch), bp)
        got[dev] = (float(loss), [g.cpu() for g in tree_flatten(grads)[0]])
    lerr = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    if lerr > REF_LOSS_RTOL:
        fail(f"smoke chimera-dataplane loss_fn: {got['cuda'][0]} vs {got['cpu'][0]}")
    gerr = max(compare("smoke chimera-dataplane gradient", a, b, atol=ATTN_ATOL)
               for a, b in zip(got["cuda"][1], got["cpu"][1]))
    log("smoke", f"chimera-dataplane smoke loss_fn (batch 2 x 64): card {got['cuda'][0]:.6f} vs "
                 f"CPU {got['cpu'][0]:.6f} (relative {lerr:.3e}, tolerance {REF_LOSS_RTOL:g}); "
                 f"{len(got['cpu'][1])} gradients, max abs diff {gerr:.3e} (tolerance "
                 f"{ATTN_ATOL:g} + {RTOL:g}*|ref|)")

    # mixtral-8x7b, softmax variant: prefill, decode, loss_fn forward
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"), use_chimera=False)
    mparams = M.init_model(cfg, torch.Generator().manual_seed(SEED + 52), device="cpu")
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 33, 47)]
    toks = rng.integers(0, cfg.vocab_size, (2, 65))
    got = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), mparams)
        engine = ServeEngine(cfg, p, batch_slots=4, max_len=128, device=dev)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=4) for i, pr in enumerate(prompts)]
        engine.prefill_batch(reqs)
        engine.run_until_done()
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
                 "labels": torch.from_numpy(toks[:, 1:]).to(dev)}
        with torch.no_grad():
            loss, _ = M.loss_fn(cfg, p, batch)
        got[dev] = ([r.generated for r in reqs], float(loss))
    if got["cuda"][0] != got["cpu"][0]:
        fail(f"smoke mixtral-8x7b: greedy generations differ: {got['cuda'][0]} vs {got['cpu'][0]}")
    lerr = abs(got["cuda"][1] - got["cpu"][1]) / abs(got["cpu"][1])
    if lerr > REF_LOSS_RTOL:
        fail(f"smoke mixtral-8x7b loss_fn: {got['cuda'][1]} vs {got['cpu'][1]}")
    log("smoke", f"mixtral-8x7b smoke, softmax variant (d_head 16): prefill_batch of "
                 f"{[len(p) for p in prompts]} tokens + 4 greedy tokens, card and CPU "
                 f"generations identical {got['cuda'][0]}; loss_fn (batch 2 x 64) {got['cuda'][1]:.6f} "
                 f"vs {got['cpu'][1]:.6f} (relative {lerr:.3e}, tolerance {REF_LOSS_RTOL:g})")
    smoke_encdec()
    launched = {name: fmod.COUNTED[name].launches - before[name] for name in kernels}
    if min(launched.values()) <= 0:
        fail(f"smoke: a kernel did not launch at the smoke widths: {launched}")
    log("smoke", f"kernel launches at the smoke widths: {launched}")


def smoke_encdec():
    """``smoke_config("whisper-tiny")`` (fp32, 2 + 2 layers, d_head 16, L 16)
    and its softmax cross-attention variant, card against CPU on the same
    weights and inputs (B 2, 96 frames, 48 tokens): ``forward`` and 40
    ``decode_step`` ticks (the Chimera ring folds at 16 and 32) within
    REF_LOGIT_TOL; the card's run launches window_attention's non-causal
    mode (and the Chimera kernels)."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import smoke_config
    from repro_torch.kernels.window_attention import ops as wops
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import tree_map

    rng = np.random.default_rng(SEED + 54)
    for use_chimera in (True, False):
        cfg = dataclasses.replace(smoke_config(ENCDEC), use_chimera=use_chimera)
        params = M.init_model(cfg, torch.Generator().manual_seed(SEED + 55), device="cpu")
        emb = rng.standard_normal((2, 96, cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size, (2, 48))
        got = {}
        for dev in ("cuda", "cpu"):
            before = wops.noncausal_launches
            p = tree_map(lambda t: t.to(dev), params)
            e = torch.from_numpy(emb).to(dev)
            tk = torch.from_numpy(toks).to(dev)
            with torch.no_grad():
                logits, _ = M.forward(cfg, p, {"tokens": tk, "enc_embeds": e})
                caches = M.init_encdec_caches(cfg, p, e, 2, 48)
                dec = [M.decode_step(cfg, p, tk[:, t], torch.full((2,), t, dtype=torch.int32,
                                                                  device=dev), caches)
                       for t in range(40)]
            if (wops.noncausal_launches > before) != (dev == "cuda"):
                fail(f"smoke whisper-tiny on {dev}: non-causal launches "
                     f"{wops.noncausal_launches - before}")
            got[dev] = (logits.cpu(), torch.stack(dec, 1).cpu())
        e_fwd = compare("smoke whisper-tiny forward logits card vs CPU", got["cuda"][0],
                        got["cpu"][0], atol=REF_LOGIT_TOL, rtol=REF_LOGIT_TOL)
        e_dec = compare("smoke whisper-tiny decode logits card vs CPU", got["cuda"][1],
                        got["cpu"][1], atol=REF_LOGIT_TOL, rtol=REF_LOGIT_TOL)
        log("smoke", f"whisper-tiny smoke ({'Chimera' if use_chimera else 'softmax'} "
                     f"cross-attention, d_head 16, L 16): forward (2 x 48 tokens, 96 frames) and "
                     f"40 decode ticks, card vs CPU: logits max abs diff {e_fwd:.3e} and "
                     f"{e_dec:.3e} (tolerance {REF_LOGIT_TOL:g} + {REF_LOGIT_TOL:g}*|ref|)")

# --------------------------------------------------------------------------
# 8. program (the compiled DataplaneProgram on the card)
# --------------------------------------------------------------------------

# Hopper's SM has 64 INT32 lanes against 128 FP32 ones (NVIDIA H100
# architecture white paper): int32 arithmetic peaks at half the fp32 rate
INT32_OPS = FP32_FLOPS / 2


def int_score_case(params, ccfg, M, seed):
    """A plan lowered from ``params`` with M rules (the program's one
    default rule, or M random ones) and random int inputs at the engine's
    256 lanes: hidden sums of up to 300 tokens of features inside the
    plan's B_h range, count-0 and vetoed lanes, rules that hit lanes."""
    import dataclasses

    import torch
    from repro_torch.compile import int_lowering as il
    from repro_torch.core.symbolic import RuleSet, words_to_int32
    from repro_torch.train import classifier as C

    g = torch.Generator().manual_seed(seed)
    W, d, B = ccfg.sig_words, ccfg.arch.d_model, LANES
    sig = words_to_int32(torch.randint(0, 2**32, (B, W), generator=g))
    if M == 1:
        rules = C.default_rules(ccfg, program_signature(), device="cuda")
    else:
        src = torch.randint(0, B, (M,), generator=g)
        masks = words_to_int32(torch.randint(0, 2**32, (M, W), generator=g))
        values = torch.where(torch.rand((M, 1), generator=g) < 0.5, sig[src],
                             words_to_int32(torch.randint(0, 2**32, (M, W), generator=g)))
        rules = RuleSet(values=values, masks=masks, weights=torch.randn((M,), generator=g),
                        hard=torch.rand((M,), generator=g) < 0.3).to("cuda")
    plan, tables, _ = il.lower_scores(dataclasses.replace(ccfg, sig_words=W), params, rules)
    count = torch.randint(0, 301, (B,), generator=g, dtype=torch.int32)
    count[:4] = 0
    h_max = int(plan.feature_range * 2 ** plan.feature_frac)
    hs = (torch.randint(-h_max, h_max + 1, (B, d), generator=g, dtype=torch.int32)
          * torch.clamp(count, min=1)[:, None])
    sticky = torch.rand((B,), generator=g) < 0.1
    return plan, tables, rules, hs.cuda(), count.cuda(), sig.cuda(), sticky.cuda()


def int_score_cost(plan, tables, rules, hs, sig):
    """Bytes and int32 operations of one int_flow_score call (each input read
    once, each output written once)."""
    B, d = hs.shape
    K = tables["cls_w"].shape[1]
    M, W = rules.values.shape
    nbytes = 4 * (B * d + B + B * W + d * K + d + 2 * M * W + M + 2 + plan.n_lut) + B + M
    nbytes += 4 * B * (K + 3) + B
    ops = B * (d * (2 * (K + 1) + 2) + 3 * M * W + 2 * M + 16)
    return nbytes, ops


def check_int_score(M, timed, params, ccfg):
    """``int_flow_score.cu`` against its plain version on the card, bit for
    bit, at the engine's 256 lanes with the plan of ``params``, on the
    kernel's fast path; timed."""
    import torch
    from repro_torch.compile import int_lowering as il
    from repro_torch.kernels.flow_ingest import int_ops

    plan, tables, rules, hs, count, sig, sticky = int_score_case(params, ccfg, M, SEED + 70 + M)
    out_k, st_k = int_ops.int_flow_score(plan, tables, rules, hs, count, sig, sticky)
    out_p, st_p = il.int_flow_score(plan, tables, rules, hs, count, sig, sticky)
    torch.cuda.synchronize()
    for k in out_p:
        compare(f"int_flow_score {k}", out_k[k], out_p[k])  # exact: integer outputs
    compare("int_flow_score sticky", st_k, st_p)
    B, d = hs.shape
    K, W = tables["cls_w"].shape[1], sig.shape[1]
    if not int_ops.fast_path(tables, rules, sig):
        fail(f"int_flow_score M={M}: the engine's shape left the kernel's fast path")
    log("program", f"int_flow_score B={B} d={d} K={K} W={W} M={M} (the fast path): "
                   f"bit-identical to the plain version ({int(out_p['hard_hit'].sum())} vetoed "
                   f"lanes, trust_q in [{int(out_p['trust_q'].min())}, "
                   f"{int(out_p['trust_q'].max())}], plan f_h {plan.feature_frac}, shifts "
                   f"{plan.nn_shift}/{plan.sym_shift}/{plan.fusion_frac}, lut_shift "
                   f"{plan.lut_shift})")
    rec = {"max_abs_err": 0.0}
    if timed:
        def kernel():
            return int_ops.int_flow_score(plan, tables, rules, hs, count, sig, sticky)

        ms, call_ms = cuda_ms(kernel, iters=200)
        plain_ms, plain_call_ms = cuda_ms(
            lambda: il.int_flow_score(plan, tables, rules, hs, count, sig, sticky), iters=50)
        floor_ms = launch_floor_ms(B)
        nbytes, ops = int_score_cost(plan, tables, rules, hs, sig)
        bound_ms, bound_by = bound(nbytes, ops, INT32_OPS)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   floor_ms=floor_ms, bytes=nbytes, ops=ops, call_ms=call_ms,
                   plain_call_ms=plain_call_ms, library_ms=None)
        log("program", f"int_flow_score M={M} device time: kernel {ms:.5f} ms, launch floor "
                       f"(an empty kernel on flow_score's grid) {floor_ms:.5f} ms, plain "
                       f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by} ({nbytes} B, "
                       f"{ops} int32 ops); per call from Python: kernel {call_ms:.4f} ms, plain "
                       f"{plain_call_ms:.4f} ms")
        if M == 1:
            # does the card's matrix product take int32 (the head MACs)?
            x = torch.div(hs, torch.clamp(count, min=1)[:, None], rounding_mode="floor")
            try:
                y = x @ tables["cls_w"]
            except RuntimeError as e:  # the probe's answer, not a fallback: nothing uses it
                log("program", f"int32 matmul on the card: refused ({str(e).splitlines()[0]})")
            else:
                compare("int32 matmul", y, il.int_mac(x, tables["cls_w"]))
                mm_ms = cuda_ms(lambda: x @ tables["cls_w"], iters=200)[0]
                rec["int32_matmul_ms"] = mm_ms
                log("program", f"int32 matmul on the card: exact, {mm_ms:.5f} ms for the class "
                               f"head's (256, {d}) @ ({d}, 8)")
    return rec


INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
# the int kernel's two paths, as a profiler names them
INT_KERNELS = ("int_flow_score_fast", "int_flow_score_generic")
# divisors max(count, 1) that strain the floor division: 0, 1 and negative
# counts (divisor 1), powers of two and their neighbours, the largest int32
INT_COUNTS = (0, 1, -5, 2, 3, 7, 641, 2**16 - 1, 2**16, 2**16 + 1, 2**30, 2**30 + 1,
              INT32_MAX - 1, INT32_MAX)
# (B, d, K, W, M, n_lut, lut_shift) of the kernel's edge cases: its fast
# path (K 8, W 24 or 8; the LUT staged, or too long or ragged to stage; odd
# B; d 32 and 64; rules past the first 32), then its generic path (W 12,
# d % 32 != 0, d > 256, K != 8, M 0)
INT_EDGES = ((256, 256, 8, 24, 1, 1024, 4), (255, 256, 8, 24, 40, 1024, -3),
             (33, 64, 8, 24, 1, 2048, 0), (7, 32, 8, 24, 65, 6, 31),
             (256, 256, 8, 8, 3, 1024, 4), (17, 64, 8, 8, 70, 1024, 5),
             (48, 64, 8, 12, 5, 1024, 4), (64, 200, 8, 24, 1, 1024, 2),
             (64, 288, 8, 24, 2, 1024, 4), (64, 256, 5, 24, 3, 1024, 4),
             (65, 96, 12, 24, 33, 512, -1), (16, 32, 8, 24, 0, 1024, 4))
INT_EDGE_FAST = 6  # the first six take the fast path, the rest the generic one


def int_adversarial_case(B, d, K, W, M, n_lut, lut_shift, seed, device):
    """An IntScorePlan and inputs, made with numpy from ``seed``, that
    strain int_flow_score's arithmetic: full-range int32 weights, biases and
    hidden sums (products and sums wrap), INT32_MIN, INT32_MAX, -1 and
    multiples of the divisor +-1 among the sums, every divisor of
    INT_COUNTS, shifts of 0 and 31 among the plan's, rules that hit lanes,
    vetoed lanes.  Returns ``(plan, tables, rules, hs, count, sig, sticky)``
    as tensors on ``device``."""
    import torch
    from repro_torch.compile import int_lowering as il
    from repro_torch.core.symbolic import RuleSet

    rng = np.random.default_rng(seed)

    def full(*shape):
        return rng.integers(INT32_MIN, INT32_MAX, shape, dtype=np.int64, endpoint=True).astype(
            np.int32)

    shifts = rng.choice([0, 1, 5, 13, 31], 3)
    plan = il.IntScorePlan(
        feature_bits=16, feature_frac=8, feature_range=8.0, weight_bits=12, cls_frac=10,
        anom_frac=10, rule_frac=10, score_frac=10, nn_shift=int(shifts[0]),
        sym_shift=int(shifts[1]), fusion_frac=int(shifts[2]), trust_frac=14, one_q=1 << 14,
        n_lut=n_lut, lut_shift=lut_shift, lut_range=8.0, u_min_q=int(full(1)[0]) // 4,
        horizon=1, has_cls_bias=bool(seed % 2), has_anom_bias=bool(seed % 3), divergence=0.0)
    tables = {"cls_w": full(d, K), "anom_w": full(d, 1), "rule_w": full(M),
              "alpha": full(), "beta": full(), "lut": full(n_lut)}
    if plan.has_cls_bias:
        tables["cls_b"] = full(K)
    if plan.has_anom_bias:
        tables["anom_b"] = full(1)
    count = rng.choice(np.array(INT_COUNTS, np.int64), B).astype(np.int32)
    count[: min(B, len(INT_COUNTS))] = INT_COUNTS[:B]
    hs = full(B, d)
    c = np.maximum(count, 1).astype(np.int64)[:, None]
    k = rng.integers(-3, 4, (B, d))
    near = np.clip(c * k + rng.integers(-1, 2, (B, d)), INT32_MIN, INT32_MAX).astype(np.int32)
    pick = rng.random((B, d))
    hs = np.where(pick < 0.3, near, hs)
    hs[:, 0], hs[:, -1] = INT32_MIN, INT32_MAX
    if d > 2:
        hs[:, 1] = -1
    sig = full(B, W)
    masks = full(M, W) & full(M, W)
    values = sig[rng.integers(0, B, M)].copy()  # rule r hits (at least) one lane
    values[np.arange(M) % 3 == 2] ^= masks[np.arange(M) % 3 == 2]  # these hit by chance only
    rules = RuleSet(values=torch.from_numpy(values), masks=torch.from_numpy(masks),
                    weights=torch.from_numpy(rng.standard_normal(M).astype(np.float32)),
                    hard=torch.from_numpy(rng.random(M) < 0.3)).to(device)
    sticky = rng.random(B) < 0.1
    to = lambda x: torch.from_numpy(np.array(x)).to(device)  # noqa: E731
    return (plan, {name: to(t) for name, t in tables.items()}, rules, to(hs), to(count), to(sig),
            to(sticky))


def check_int_score_edges():
    """int_flow_score.cu at INT_EDGES on adversarial inputs, bit for bit
    against its plain version on the CPU (the same inputs), the first
    INT_EDGE_FAST on the launcher's fast path and the rest on its generic
    one."""
    import torch
    from repro_torch.compile import int_lowering as il
    from repro_torch.kernels.flow_ingest import int_ops

    paths = []
    for i, (B, d, K, W, M, n_lut, lut_shift) in enumerate(INT_EDGES):
        case = int_adversarial_case(B, d, K, W, M, n_lut, lut_shift, SEED + 80 + i, "cuda")
        plan, tables, rules, *xs = case
        what = f"int_flow_score edge B={B} d={d} K={K} W={W} M={M} n_lut={n_lut}"
        path = "fast" if int_ops.fast_path(tables, rules, xs[2]) else "generic"
        if path != ("fast" if i < INT_EDGE_FAST else "generic"):
            fail(f"{what}: the launcher takes its {path} path")
        out_k, st_k = int_ops.int_flow_score(plan, tables, rules, *xs)
        out_p, st_p = il.int_flow_score(plan, {k: t.cpu() for k, t in tables.items()},
                                        rules.to("cpu"), *(x.cpu() for x in xs))
        torch.cuda.synchronize()
        for k in out_p:
            compare(f"{what} {k}", out_k[k], out_p[k])
        compare(f"{what} sticky", st_k, st_p)
        paths.append(f"{B}x{d} K{K} W{W} M{M} n_lut {n_lut}: {path} "
                     f"({int(out_p['hard_hit'].sum())} vetoed)")
    log("program", f"int_flow_score edge shapes on adversarial inputs (full-range int32 "
                   f"weights and sums, INT32_MIN/MAX, divisors {list(INT_COUNTS)}), bit-identical "
                   f"to the plain version on the CPU: " + "; ".join(paths))


def program_signature():
    """The anomaly signature of the program's default rule: the protocol-mix
    stream's, which the rule-violating stream of the same seed shares."""
    from repro_torch.data.pipeline import FlowScenario

    return FlowScenario(kind="protocol-mix", seed=SEED).anomaly_signature


def program_rules(ccfg, device):
    """Two rules at the compiled layout: the default hard rule on the
    anomaly signature, and a soft one on half of its markers."""
    import torch
    from repro_torch.core.symbolic import RuleSet
    from repro_torch.train import classifier as C

    sig = program_signature()
    hard = C.default_rules(ccfg, sig, device=device)
    soft = C.default_rules(ccfg, sig[:2], device=device)
    return RuleSet(values=torch.cat([hard.values, soft.values]),
                   masks=torch.cat([hard.masks, soft.masks]),
                   weights=torch.tensor([4.0, 1.5], device=device),
                   hard=torch.tensor([True, False], device=device))


class RoundMargins:
    """Per-packet top-2 class-logit margins of a per-round engine's last
    batch (the margin rule of ``hold_outputs``): keeps a copy of the score
    stage's logits on the card while entered (no wait for the card), and
    reads them in ``margins``."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        from repro_torch.train import classifier as C

        self.rounds, self.slots = [], None
        self._scores, self._ingest = C.streaming_scores, self.engine._ingest_rounds

        def scores(*a, **k):
            out, sticky = self._scores(*a, **k)
            self.rounds.append(out["class_logits"].detach().clone())
            return out, sticky

        def rounds(flow_ids, tokens, slots, fresh):
            self.rounds, self.slots = [], slots.copy()
            return self._ingest(flow_ids, tokens, slots, fresh)

        C.streaming_scores = scores
        self.engine._ingest_rounds = rounds
        return self

    def __exit__(self, *exc):
        from repro_torch.train import classifier as C

        C.streaming_scores = self._scores
        del self.engine._ingest_rounds

    def margins(self):
        from repro_torch.data.pipeline import arrival_rounds

        lanes = self.engine.fcfg.lanes
        logits = np.empty((len(self.slots), self.rounds[0].shape[1]), np.float32)
        chunks = [r[c0:c0 + lanes] for r in arrival_rounds(self.slots.tolist())
                  for c0 in range(0, len(r), lanes)]
        for chunk, lg in zip(chunks, self.rounds):
            logits[chunk] = lg[: len(chunk)].cpu().numpy()
        top2 = np.sort(logits, axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]


def phase_program():
    """The compiled-program surface on the card.

    1. int_flow_score.cu against its plain version, bit for bit, at the
       engine's shapes (B 256, d 256, K 8, W 24; M 1 and M 300) with plans
       lowered from the paper classifier's seed-0 weights, timed beside the
       launch floor; flow_score at W 24 (its generic path).
    2. The main path, with the launch counters zeroed just before and read
       just after: the paper's classifier compiled in the port (float
       backend, waivers ("state-quantization",), verify=False), saved,
       loaded and deployed per-round and fused (capacity 4096, lanes 256);
       protocol-mix and rule-violating batches with two swaps between them
       (a compile_delta of new weights, then a ruleset whose soft rule turns
       hard), fused held to per-round after each.  Then the int-emulation
       engines at the smoke width, per-round and fused, each beside the
       same engine on the CPU, with one swap_tables(delta=...) mid-stream.
    """
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.compile import DataplaneProgram, compile_delta, compile_program
    from repro_torch.compile import int_lowering as il
    from repro_torch.core.symbolic import decompile_table
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.flow_ingest import fused as fmod
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig

    recs = {}
    ccfg, params = paper_classifier(n_layers=FLOW_LAYERS)
    ccfg24 = dataclasses.replace(ccfg, sig_words=24)  # the layout the compile gives
    recs["int_flow_score"] = check_int_score(1, True, params, ccfg24)
    r300 = check_int_score(300, True, params, ccfg24)
    recs["int_flow_score"]["other_shapes"] = [dict(
        {k: r300[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        shape="B 256 d 256 K 8 W 24 M 300")]
    check_int_score_edges()
    recs["flow_score_w24"] = check_score(2, True, W=24)

    counted = ("decode_step", "flow_score", "int_flow_score")
    for name in counted:
        fmod.COUNTED[name].launches = 0

    # --- the float program at the paper's width -------------------------
    t0 = time.perf_counter()
    program = compile_program(ccfg, params, rules=lambda c: program_rules(c, "cuda"),
                              waivers=("state-quantization",), verify=False)
    compile_s = time.perf_counter() - t0
    print(program.ledger.as_table(), flush=True)
    tmp = tempfile.mkdtemp(prefix="chimera-program-")
    try:
        t0 = time.perf_counter()
        program.save(tmp)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = DataplaneProgram.load(tmp, device="cuda")
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    for a, b in zip(loaded.rules.tensors(), program.rules.tensors()):
        compare("loaded program rules", a, b)
    compare("loaded program weight table", loaded.weight_table, program.weight_table)
    if loaded.ccfg != program.ccfg or loaded.ledger.as_dict() != program.ledger.as_dict():
        fail("program: the loaded program's config or ledger differs from the saved one")
    log("program", f"chimera-dataplane compiled in {compile_s:.2f} s (sig_words "
                   f"{program.ccfg.sig_words}, {program.rules.n_rules} rules, backend "
                   f"{program.backend}, waived {[e.resource for e in program.ledger.waived()]}), "
                   f"saved in {save_s:.2f} s, loaded in {load_s:.2f} s: arrays identical")

    budget = torch.cuda.mem_get_info()[0] // 3  # two tables, and room for the graphs
    engines = {}
    for label in ("per-round", "fused"):
        fcfg = FlowEngineConfig(capacity=CAPACITY, lanes=LANES, state_budget_bytes=budget,
                                fused=label == "fused")
        engines[label] = loaded.deploy(DeploySpec(flow=fcfg, device="cuda"))
    engines["fused"].warm_fused(PKT_LEN)
    mix = FlowScenario(kind="protocol-mix", pkt_len=PKT_LEN, packets_per_batch=256, seed=SEED)
    bad = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=256, seed=SEED,
                       fid_base=1 << 32)
    # the second swap: the soft rule turns hard, with new weights
    hard_rules = dataclasses.replace(program_rules(loaded.ccfg, "cuda"),
                                     hard=torch.tensor([True, True], device="cuda"),
                                     weights=torch.tensor([4.0, 2.0], device="cuda"))
    plan = [("mix", mix), ("swap", compile_delta(loaded, weights=[3.0, -1.0], step=1)),
            ("mix", mix), ("mix", mix), ("rule-violating", bad),
            ("swap", hard_rules), ("mix", mix), ("rule-violating", bad)]
    walls = {label: 0.0 for label in engines}
    n_timed, worst, vetoes, installs = 0, {k: 0.0 for k in FLOATS}, [], []
    swapped_hard = False  # after the ruleset swap, the turned rule must veto
    tol = REFERENCE_TOL[64]
    margins = RoundMargins(engines["per-round"])
    for i, (kind, x) in enumerate(plan):
        if kind == "swap":
            delta = hasattr(x, "weight_table")
            installs.append([(e.swap_tables(delta=x) if delta else e.swap_tables(ruleset=x))
                             .install_s for e in engines.values()])
            swapped_hard = not delta
            continue
        b = x.next_batch()
        outs = {}
        for label, e in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "per-round":
                with margins:
                    outs[label] = e.ingest(b["flow_ids"], b["tokens"])
            else:
                outs[label] = e.ingest(b["flow_ids"], b["tokens"])
            torch.cuda.synchronize()
            if kind == "mix" and i > 0:
                walls[label] += time.perf_counter() - t0
        if kind == "mix" and i > 0:
            n_timed += len(b["flow_ids"])
        errs = hold_outputs(f"program batch {i} ({kind}): fused vs per-round", outs["fused"],
                            outs["per-round"], tol, margins.margins())
        worst = {k: max(worst[k], errs[k]) for k in FLOATS}
        vetoes.append(int(outs["per-round"]["vetoed"].sum()))
        if engines["fused"].stats != engines["per-round"].stats:
            fail(f"program batch {i}: FlowStats of the two engines differ")
        if swapped_hard:  # every packet whose signature hits the turned rule is vetoed
            w = hard_rules.values[1].cpu().numpy().view(np.uint32)
            hit = ((outs["fused"]["sig"] & w) == w).all(-1)
            if not outs["fused"]["vetoed"][hit].all():
                fail(f"program batch {i}: a packet that hits the rule turned hard is not vetoed")
    if max(vetoes) == 0:
        fail(f"program: no packet was vetoed ({vetoes})")
    pps = {label: n_timed / w for label, w in walls.items()}
    log("program", f"deployed per-round and fused (capacity {CAPACITY}, lanes {LANES}) "
                   f"from the loaded program: {len(plan) - 2} batches, 2 swaps, fused held to "
                   f"per-round after each (decisions identical, vetoes per batch {vetoes}, pred "
                   f"where the top-2 margin exceeds {REF_PRED_MARGIN:g}; max diffs "
                   + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f", tolerance {tol:g})")
    log("program", f"packets/s over {n_timed} protocol-mix packets: per-round "
                   f"{pps['per-round']:.1f}, fused {pps['fused']:.1f} (synchronous ingest); "
                   f"install_s (per-round, fused): delta " +
                   ", ".join(f"{a:.6f}" for a in installs[0]) + "; ruleset " +
                   ", ".join(f"{a:.6f}" for a in installs[1]))
    recs["program"] = {"pps": pps, "installs": installs}
    del engines, margins

    # --- int-emulation at the smoke width, card beside CPU ----------------
    from repro_torch.configs.registry import smoke_config
    from repro_torch.train import classifier as C

    arch = dataclasses.replace(smoke_config("chimera-dataplane"), vocab_size=512)
    sccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)
    sparams = C.init_classifier(sccfg, torch.Generator().manual_seed(SEED + 60), device="cpu")
    sc = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=48,
                      seed=SEED + 61)
    iprog = compile_program(sccfg, sparams, backend="int-emulation", verify=False,
                            rules=lambda c: C.default_rules(c, sc.anomaly_signature, device="cpu"))
    delta = compile_delta(iprog, weights=[-2.5], step=1)
    fcfg = dict(capacity=24, lanes=16, state_budget_bytes=1 << 40, idle_timeout=2)
    ieng = {}
    for dev in ("cuda", "cpu"):
        for fused in (False, True):
            ieng[dev, fused] = iprog.deploy(DeploySpec(
                flow=FlowEngineConfig(fused=fused, **fcfg), device=dev))
    iplan = ieng["cpu", False]._int_plan
    rule_w = ieng["cuda", True]._int_tables["rule_w"]  # the tensor the graphs read
    ptr = rule_w.data_ptr()
    batches = [sc.next_batch() for _ in range(4)]
    boundary_flows = {fused: set() for fused in (False, True)}
    moved = {fused: 0 for fused in (False, True)}
    n_pkts, after_swap_hits = 0, 0
    for i, b in enumerate(batches):
        if i == 2:
            for e in ieng.values():
                e.swap_tables(delta=delta)
            new_w = decompile_table(delta.weight_table, delta.weight_spec)
            if rule_w.data_ptr() != ptr or not torch.equal(
                    rule_w.cpu(), il.requantize_rule_weights(iplan, new_w)):
                fail("program: the fused card engine's rule_w was not rewritten in place")
        outs = {k: e.ingest(b["flow_ids"], b["tokens"]) for k, e in ieng.items()}
        n_pkts += len(b["flow_ids"])
        for fused in (False, True):
            got, want = outs["cuda", fused], outs["cpu", fused]
            ge, we = ieng["cuda", fused], ieng["cpu", fused]
            for k in ("vetoed", "sig"):
                if not (got[k] == want[k]).all():
                    fail(f"program int fused={fused} batch {i}: {k} differs card vs CPU")
            if not ((got["trust"] == 1.0) == got["vetoed"]).all():
                fail(f"program int fused={fused} batch {i}: trust == 1.0 is not exactly the veto")
            if ge.stats != we.stats or ge.table.slot_of != we.table.slot_of:
                fail(f"program int fused={fused} batch {i}: stats or slots differ card vs CPU")
            ghs, whs = ge.hidden_sum.cpu().numpy().astype(np.int64), we.hidden_sum.numpy()
            for fid, slot in we.table.slot_of.items():
                delta_hs = np.abs(ghs[slot] - whs[slot])
                if (delta_hs > we.positions[slot].item()).any():
                    fail(f"program int fused={fused}: flow {fid}'s hidden_sum differs by more "
                         f"than one LSB per token card vs CPU")
                if delta_hs.any():
                    boundary_flows[fused].add(fid)
            diff = np.zeros(len(b["flow_ids"]), bool)
            for k in ("trust", "s_nn", "s_sym", "pred"):
                diff |= got[k] != want[k]
            on_edge = np.array([f in boundary_flows[fused] for f in b["flow_ids"].tolist()])
            if (diff & ~on_edge).any():
                fail(f"program int fused={fused} batch {i}: quantized scores differ on a flow "
                     f"whose accumulator does not")
            moved[fused] += int(diff.sum())
        if i >= 2:
            after_swap_hits += int((outs["cuda", True]["s_sym"] != 0).sum())
    if after_swap_hits == 0:
        fail("program int: no rule hit after the swap, so the swap's table went unread")
    log("program", f"int-emulation at the smoke width (d 64, rule_w of 1 rule): per-round and "
                   f"fused on the card vs the CPU, {len(batches)} rule-violating batches "
                   f"({n_pkts} packets), swap_tables(delta) after batch 2 rewrote the graphed "
                   f"rule_w in place (requantized at 2^-{iplan.rule_frac}, "
                   f"{after_swap_hits} rule hits read it after): decisions identical, quantized "
                   f"scores identical but on {moved[False]} / {moved[True]} packets of boundary "
                   f"flows (per-round / fused; {len(boundary_flows[False])} / "
                   f"{len(boundary_flows[True])} flows whose int32 hidden_sum moved by a "
                   f"rounding LSB)")

    launched = {name: fmod.COUNTED[name].launches for name in counted}
    if min(launched.values()) == 0:
        fail(f"program: a kernel was never launched on the program's main path: {launched}")
    log("program", f"launches on the program's main path: {launched}")
    recs["launches"] = launched
    # the kernel's device time per launch inside the fused engine's graphs
    # (the smoke width: lanes 16, d 64), from a profiler trace of 5 ingests
    # after the main path's launches were read
    fe = ieng["cuda", True]
    traced = profiled_kernel_ms(lambda: fe.ingest(batches[-1]["flow_ids"],
                                                  batches[-1]["tokens"]), INT_KERNELS, iters=5)
    recs["int_fused"] = traced
    log("program", f"int_flow_score per launch in the fused int-emulation graphs (lanes "
                   f"{fe.fcfg.lanes}, d {arch.d_model}, a profiler trace of 5 ingests): " +
                   ", ".join(f"{x} {fmt_ms(t and t[0])} over {t and t[1]} launches"
                             for x, t in traced.items()))
    return recs


# --------------------------------------------------------------------------
# 20. verify: the compiler's static verification, the graph-capture sentry
#     and the quantized state cache
# --------------------------------------------------------------------------

VERIFY_BATCHES = 2  # protocol-mix and rule-violating batches each, under the sentry
QUANT_TICKS = 8  # quant_decode_step ticks held against the plain version
QUANT_WARM = 70  # fp32 decode tokens before the state is quantized (a fold at L 64)
ELASTIC_CAPACITY = 1024  # flows per logical shard in the elastic cycle


def log_rows(what, program):
    """Log a program's static-verification rows; fail unless all are ok."""
    rows = [e for e in program.ledger.entries if e.stage == "static-verification"]
    if not rows or not all(e.ok for e in rows):
        fail(f"verify {what}: static-verification rows {[e.as_dict() for e in rows]}")
    log("verify", f"{what}: {len(rows)} static-verification rows (resource used/budget): "
                  + ", ".join(f"{e.resource} {e.used:g}/{e.budget:g}" for e in rows))


def sentry_run(what, engine, batches):
    """Warm the fused engine (every width captured, one tick), then ingest
    ``batches`` under the graph-capture sentry: no capture after warm-up."""
    from repro_torch.analysis import RetraceError, RetraceSentry

    sentry = RetraceSentry.for_engine(engine)
    engine.warm_fused(PKT_LEN)
    b = batches[0][1].next_batch()
    engine.ingest(b["flow_ids"], b["tokens"])
    warm = sentry.counts()
    vetoes = []
    try:
        with sentry.expect_no_retrace():
            for kind, sc in batches:
                b = sc.next_batch()
                out = engine.ingest(b["flow_ids"], b["tokens"])
                if not ((out["trust"] == 1.0) == out["vetoed"]).all():
                    fail(f"verify {what}: trust == 1.0 is not exactly the veto ({kind})")
                vetoes.append(int(out["vetoed"].sum()))
    except RetraceError as e:
        fail(f"verify {what}: {e}")
    if len(engine.fused_graphs()) != warm["fused"]:
        fail(f"verify {what}: {len(engine.fused_graphs())} graphs, the sentry counts "
             f"{warm['fused']}")
    log("verify", f"{what}: {warm['fused']} CUDA graphs captured at warm-up "
                  f"({sorted(engine.fused_graphs())}), then {len(batches)} batches "
                  f"({', '.join(k for k, _ in batches)}) under expect_no_retrace: 0 captures; "
                  f"vetoes per batch {vetoes}")
    return vetoes


class QuantCache:
    """quant_decode_step at the engine's capacity (B 4096 flows x Hkv 4, m 256,
    d = dv 64, L 64, n_global 64).  The constructor sets up: an fp32 run of
    QUANT_WARM tokens through the kernel, with the fill levels then spread
    over the ring (one flow in eight folds inside the window), quantized.
    ``ticks`` is the main path: QUANT_TICKS ticks through decode_step.cu.
    ``quant_state_check`` repeats each tick from the same quantized state
    with the plain version on the card, runs the same ticks unquantized,
    and times both."""

    def __init__(self):
        import torch
        from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
        from repro_torch.core import chimera_attention as CA
        from repro_torch.core import state_quant as SQ

        self.cfg = cfg = ARCH.chimera
        self.B, H, Hkv, d = CAPACITY, ARCH.n_heads, ARCH.n_kv_heads, ARCH.head_dim
        g = torch.Generator(device="cuda").manual_seed(SEED + 90)
        self.params = CA.init_chimera_attention(cfg, Hkv, d, d, g, device="cuda")

        def token():
            return (torch.randn((self.B, H, d), generator=g, device="cuda"),
                    torch.randn((self.B, Hkv, d), generator=g, device="cuda"),
                    torch.randn((self.B, Hkv, d), generator=g, device="cuda"))

        self.state = CA.init_decode_state(cfg, self.B, Hkv, d, d, device="cuda")
        for _ in range(QUANT_WARM):
            CA.chimera_decode_step(cfg, self.params, *token(), self.state)
        self.state.count = (torch.arange(self.B, dtype=torch.int32, device="cuda")
                            % cfg.chunk_size)
        self.toks = [token() for _ in range(QUANT_TICKS)]
        self.qs = [SQ.quantize_state(self.state)]
        self.shape = (f"B {self.B} x Hkv {Hkv} (m {cfg.feature_map.m}, d = dv {d}, "
                      f"L {cfg.chunk_size}, n_global {cfg.n_global})")
        torch.cuda.synchronize()

    def ticks(self):
        import torch
        from repro_torch.core import state_quant as SQ

        self.outs = []
        for t in range(QUANT_TICKS):
            out, nq = SQ.quant_decode_step(self.cfg, self.params, *self.toks[t], self.qs[-1])
            self.outs.append(out)
            self.qs.append(nq)
        torch.cuda.synchronize()


def quant_state_check(qc):
    """``QuantCache``'s checks and timings, after the main path's launches
    were read."""
    import torch
    from repro_torch.core import chimera_attention as CA
    from repro_torch.core import state_quant as SQ

    cfg, params, B = qc.cfg, qc.params, qc.B
    state, toks, qs, outs = qc.state, qc.toks, qc.qs, qc.outs
    fp_bytes, q_bytes = SQ.state_bytes(state), SQ.state_bytes(qs[0])

    # each tick from the same quantized state: the plain version on the card
    err_out = err_float = 0.0
    moved = total = 0
    for t in range(QUANT_TICKS):
        with plain_chimera_kernels(decode="plain"):
            out_p, nq_p = SQ.quant_decode_step(cfg, params, *toks[t], qs[t])
            st_p = SQ.dequantize_state(qs[t])
            CA.chimera_decode_step(cfg, params, *toks[t], st_p)
        st_k = SQ.dequantize_state(qs[t])
        CA.chimera_decode_step(cfg, params, *toks[t], st_k)
        err_out = max(err_out, compare(f"quant tick {t} out", outs[t], out_p))
        for name in ("S", "Z"):  # the float steps before requantizing
            err_float = max(err_float, compare(f"quant tick {t} {name}", getattr(st_k, name),
                                               getattr(st_p, name)))
        compare(f"quant tick {t} count", qs[t + 1].count, nq_p.count)
        for name in ("S_scale", "Z_scale"):
            compare(f"quant tick {t} {name}", getattr(qs[t + 1], name), getattr(nq_p, name))
        for name in ("S_q", "Z_q"):
            diff = (getattr(qs[t + 1], name).long() - getattr(nq_p, name).long()).abs()
            if int(diff.max()) > 1:
                fail(f"verify quant tick {t}: {name} differs by {int(diff.max())} steps")
            moved += int((diff != 0).sum())
            total += diff.numel()
        del st_p, st_k, out_p, nq_p

    # the same ticks on an unquantized fp32 state
    st = CA.ChimeraState(*(x.clone() for x in state.leaves()))
    err_unq = 0.0
    for t in range(QUANT_TICKS):
        out = CA.chimera_decode_step(cfg, params, *toks[t], st)
        err_unq = max(err_unq, float((outs[t] - out).abs().max()))
    back = SQ.dequantize_state(qs[-1])
    rel_S = float(torch.linalg.norm(back.S - st.S) / torch.linalg.norm(st.S))
    rel_Z = float(torch.linalg.norm(back.Z - st.Z) / torch.linalg.norm(st.Z))
    del back

    quant_ms = event_ms(lambda: SQ.quant_decode_step(cfg, params, *toks[0], qs[0]), iters=5)
    with plain_chimera_kernels(decode="plain"):
        quant_plain_ms = event_ms(lambda: SQ.quant_decode_step(cfg, params, *toks[0], qs[0]),
                                  iters=3)
    fp_ms = event_ms(lambda: CA.chimera_decode_step(cfg, params, *toks[0], st), iters=5)
    rec = {"B": B, "ticks": QUANT_TICKS, "max_abs_err": err_out,
           "float_state_err": err_float, "requant_moved": moved, "requant_total": total,
           "out_vs_unquantized": err_unq, "rel_S": rel_S, "rel_Z": rel_Z,
           "state_bytes": q_bytes, "fp32_state_bytes": fp_bytes, "ms": quant_ms,
           "plain_ms": quant_plain_ms, "fp32_step_ms": fp_ms}
    log("verify", f"quant_decode_step {qc.shape}, {QUANT_TICKS} ticks through decode_step.cu "
                  f"against the plain version on the card from the same "
                  f"quantized state: out max abs err {err_out:.3e}, float S/Z before requantizing "
                  f"{err_float:.3e} (tolerance {ATOL:g} + {RTOL:g}*|ref|); requantized ints one "
                  f"step apart on {moved} of {total} elements ({moved / total:.3e}), equal "
                  f"elsewhere")
    log("verify", f"quant_decode_step against an unquantized fp32 run of the same ticks: out "
                  f"max abs err {err_unq:.3e}, dequantized state rel err S {rel_S:.3e} Z "
                  f"{rel_Z:.3e}; state_bytes {q_bytes} quantized vs {fp_bytes} fp32 "
                  f"({fp_bytes / q_bytes:.3f}x); device ms per step (CUDA events, 5 calls): "
                  f"quantized {quant_ms:.3f} (plain version {quant_plain_ms:.3f}), unquantized "
                  f"{fp_ms:.3f}")
    del qc.qs, qc.outs, qc.state, st
    torch.cuda.empty_cache()
    return rec


def phase_verify():
    """The compiler's pass 6, the graph-capture sentry and the quantized
    state cache on the card.

    1. The paper's classifier (FLOW_LAYERS of its layers, seed-0 weights)
       compiled with ``verify=True`` on the float backend and on
       int-emulation (its Thm A.3 divergence is over budget at this width,
       so that stage is waived and the engine must refuse the deploy); every
       static-verification row logged and ok.
    2. The main path, launch counters zeroed just before and read just
       after: the float program deployed fused (capacity 4096, lanes 256),
       warmed, protocol-mix and rule-violating batches under
       ``expect_no_retrace``; the int-emulation program at the smoke width,
       compiled with verification, deployed fused the same way; the elastic
       reshard cycle (1 -> 2 -> 1 logical shards at the paper's width)
       under the sentry; then ``QuantCache.ticks``.
    3. The gate's two canaries.
    """
    import dataclasses

    import torch
    from repro_torch.analysis import gate
    from repro_torch.compile import BudgetError, compile_program
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.flow_ingest import fused as fmod
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig
    from repro_torch.train import classifier as C

    ccfg, params = paper_classifier(n_layers=FLOW_LAYERS)
    t0 = time.perf_counter()
    fprog = compile_program(ccfg, params, rules=lambda c: program_rules(c, "cuda"),
                            waivers=("state-quantization",))
    log_rows(f"chimera-dataplane ({FLOW_LAYERS} layer) float backend, compiled with "
             f"verification in {time.perf_counter() - t0:.2f} s", fprog)
    t0 = time.perf_counter()
    iprog = compile_program(ccfg, params, rules=lambda c: program_rules(c, "cuda"),
                            backend="int-emulation",
                            waivers=("state-quantization", "int-lowering"))
    log_rows(f"chimera-dataplane ({FLOW_LAYERS} layer) int-emulation, compiled with "
             f"verification in {time.perf_counter() - t0:.2f} s", iprog)
    div = [e for e in iprog.ledger.entries if e.resource == "trust-divergence"][0]
    try:
        iprog.deploy(DeploySpec(flow=FlowEngineConfig(capacity=CAPACITY, lanes=LANES,
                                                      fused=True), device="cuda"))
        fail("verify: the full-width int-emulation deploy was not refused")
    except BudgetError as e:
        if "trust-divergence" not in str(e):
            fail(f"verify: the full-width int deploy was refused for another reason: {e}")
    log("verify", f"the full-width int-emulation program (trust-divergence {div.used:.6g} > "
                  f"{div.budget:g}, waived at compile) is refused at deploy (BudgetError), as "
                  f"in both packages")

    qc = QuantCache()  # set-up: its warm-up launches are not the main path's
    counted = ("decode_step", "flow_score", "int_flow_score")
    for name in counted:
        fmod.COUNTED[name].launches = 0
    budget = torch.cuda.mem_get_info()[0] // 4
    fcfg = FlowEngineConfig(capacity=CAPACITY, lanes=LANES, fused=True, state_budget_bytes=budget)

    def traffic(seed):
        scs = [(kind, FlowScenario(kind=kind, pkt_len=PKT_LEN, packets_per_batch=256, seed=seed,
                                   fid_base=base))
               for kind, base in (("protocol-mix", 0), ("rule-violating", 1 << 32))]
        return [ks for ks in scs for _ in range(VERIFY_BATCHES)]

    eng = fprog.deploy(DeploySpec(flow=fcfg, device="cuda"))
    vetoes = sentry_run(f"float program fused (capacity {CAPACITY}, lanes {LANES})", eng,
                        traffic(SEED))
    if max(vetoes) == 0:
        fail("verify: no packet was vetoed by the float program")
    del eng
    torch.cuda.empty_cache()

    arch = dataclasses.replace(smoke_config("chimera-dataplane"), vocab_size=512)
    sccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)
    sparams = C.init_classifier(sccfg, torch.Generator().manual_seed(SEED + 60), device="cuda")
    sig = FlowScenario(kind="rule-violating", seed=SEED + 61).anomaly_signature
    sprog = compile_program(sccfg, sparams, backend="int-emulation",
                            rules=lambda c: C.default_rules(c, sig, device="cuda"))
    log_rows("smoke chimera-dataplane int-emulation", sprog)
    ieng = sprog.deploy(DeploySpec(flow=fcfg, device="cuda"))
    sentry_run(f"int-emulation program (smoke width) fused (capacity {CAPACITY}, lanes {LANES})",
               ieng, traffic(SEED + 61))
    del ieng

    mix = FlowScenario(kind="protocol-mix", pkt_len=PKT_LEN, packets_per_batch=256, seed=SEED)
    t0 = time.perf_counter()
    el = gate.elastic_reshard_audit(
        fprog, mix, "cuda",
        fcfg=FlowEngineConfig(capacity=ELASTIC_CAPACITY, lanes=LANES, state_budget_bytes=budget))
    if not el["ok"]:
        fail(f"verify elastic: {el['detail']}")
    log("verify", f"elastic at the paper's width ({ELASTIC_CAPACITY} flows x lanes {LANES} per "
                  f"shard), {time.perf_counter() - t0:.1f} s: {el['detail']}")
    torch.cuda.empty_cache()

    before = fmod.COUNTED["decode_step"].launches
    qc.ticks()
    quant_launches = fmod.COUNTED["decode_step"].launches - before
    launched = {name: fmod.COUNTED[name].launches for name in counted}
    if min(launched.values()) == 0:
        fail(f"verify: a kernel was never launched on the phase's main path: {launched}")
    if quant_launches != QUANT_TICKS:
        fail(f"verify quant: {quant_launches} decode_step launches for {QUANT_TICKS} ticks")
    log("verify", f"launches on the phase's main path: {launched} (decode_step: "
                  f"{quant_launches} of them in the {QUANT_TICKS} quant_decode_step ticks)")
    quant = quant_state_check(qc)
    quant["launches"] = quant_launches

    for c in gate.canaries():
        if not c["ok"]:
            fail(f"verify canary {c['name']}: {c['detail']}")
        log("verify", f"canary {c['name']}: ok ({c['detail']})")
    return {"launches": launched, "quant": quant}


# --------------------------------------------------------------------------
# 9. adapt: the closed adaptation loop, its traffic and the red-team gate
# --------------------------------------------------------------------------

ADAPT_ARGS = ["--fused", "--capacity", str(CAPACITY), "--lanes", str(LANES),
              "--packets", "256", "--pkt-len", str(PKT_LEN)]
ADAPT_TOL = 1e-2  # card vs CPU floats at the tiny width (the program phase's)
TINY_FLOW = dict(capacity=512, lanes=16)  # the CPU tests' canonical replay
TINY_POLICY = dict(warmup_ticks=2, cooldown_ticks=4, sig_novelty=0.05, churn_shift=0.12)
HISTORY_FIELDS = ("tick", "fired_on", "installed", "install_tick", "rolled_back")


def hold_invariants(what, batches, outputs):
    """S pinned to 1.0 exactly on the vetoed packets, and no veto flip."""
    from repro_torch.serve.redteam import TrustInvariantTracker

    tr = TrustInvariantTracker()
    for b, out in zip(batches, outputs):
        tr.observe(b["flow_ids"], out)
    if tr.pinning_violations or tr.veto_flips:
        fail(f"{what}: {tr.pinning_violations} pinning violations, {tr.veto_flips} veto flips")
    return tr


def hold_loop(what, loop):
    """A trigger, and every install inside t_cp or rolled back."""
    if not loop.history:
        fail(f"{what}: the drift policy never fired")
    for r in loop.history:
        if r.installed and not r.churn_ok:
            fail(f"{what}: an install outside t_cp at tick {r.tick} was not rolled back")
        if r.rolled_back and r.installed:
            fail(f"{what}: tick {r.tick} both installed and rolled back")


def adapt_full_width():
    """(a) The launcher's build-and-serve code at the paper's width
    (FLOW_LAYERS of its layers) on the default drift schedule's batches: with no loop (the staging ring),
    under the sync loop and under the async loop, each twice, in turns
    (no, sync, async, async, sync, no) so that an effect of the order on
    the timing cancels in the pairs."""
    import torch
    from repro_torch.analysis import RetraceError, RetraceSentry
    from repro_torch.data.pipeline import DriftScenario, parse_phases
    from repro_torch.launch import flow_serve as F

    ccfg, params = paper_classifier(n_layers=FLOW_LAYERS)
    budget = torch.cuda.mem_get_info()[0] // 3
    phases = DriftScenario(phases=parse_phases(F.DEFAULT_DRIFT))
    runs, first_outs = {}, {}
    flags = {"no loop": ["--drift-phases", F.DEFAULT_DRIFT],
             "sync loop": ["--adapt", "--adapt-sync"], "async loop": ["--adapt"]}
    for mode in ("no loop", "sync loop", "async loop", "async loop", "sync loop", "no loop"):
        extra = flags[mode]
        args = F.parse_args(ADAPT_ARGS + extra + ["--batches", str(phases.batches_per_cycle),
                                                  "--state-budget-bytes", str(budget)])
        t0 = time.perf_counter()
        dep = F.build(args, params=params, arch=ccfg.arch)
        build_s = time.perf_counter() - t0
        if dep.program.ccfg.arch != ccfg.arch:
            fail("adapt: the launcher's arch is not the paper classifier's")
        eng = dep.engine
        warmed = set(eng.fused_graphs())
        try:
            fused = RetraceSentry({"fused": eng.capture_entry_points()["fused"]})
            with fused.expect_no_retrace():
                res = F.serve(dep, keep=True)
        except RetraceError as e:
            fail(f"adapt {mode}: a CUDA graph was captured after warm-up: {e}")
        hold_invariants(f"adapt {mode}", res.batches, res.outputs)
        if eng.stats.flows_evicted:
            fail(f"adapt {mode}: {eng.stats.flows_evicted} evictions")
        veto = {}
        for i, (b, out) in enumerate(zip(res.batches, res.outputs)):
            ph = phases.phase_index(i)
            n, v = veto.get(ph, (0, 0))
            veto[ph] = (n + len(out["vetoed"]), v + int(out["vetoed"].sum()))
        rec = {"pps": res.packets_per_s, "packets": res.packets, "seconds": res.seconds,
               "build_s": build_s,
               "veto_rate": {ph: v / max(n, 1) for ph, (n, v) in sorted(veto.items())}}
        loop = dep.loop
        if loop is not None:
            hold_loop(f"adapt {mode}", loop)
            # before the first fire every run serves the deployed tables
            for i in range(loop.history[0].tick):
                for k in ("vetoed", "sig"):
                    if not (res.outputs[i][k] == first_outs["no loop"][i][k]).all():
                        fail(f"adapt {mode}: batch {i} {k} differs from the run with no loop")
            rec.update(
                triggers=loop.trigger_ticks, installs=loop.installs,
                install_ticks=[r.install_tick for r in loop.history],
                fired_on=[list(r.fired_on) for r in loop.history],
                drift_ms=1e3 * float(np.mean(loop.drift_s)),
                drift_ms_max=1e3 * float(np.max(loop.drift_s)),
                epoch_ms=[1e3 * r.epoch_s for r in loop.history],
                install_us=[1e6 * r.install_s for r in loop.history],
                rolled_back=sum(r.rolled_back for r in loop.history))
        # the second run with no loop, and the second sync run (installs at
        # the same ticks), must repeat the first one's decisions
        if mode in first_outs and mode != "async loop":
            for i, (a, b) in enumerate(zip(res.outputs, first_outs[mode])):
                if not all((a[k] == b[k]).all() for k in ("vetoed", "sig")):
                    fail(f"adapt {mode}: batch {i} differs from the first run of its mode")
        first_outs.setdefault(mode, res.outputs)
        runs.setdefault(mode, []).append(rec)
        log("adapt", f"full width, {mode} (compile, deploy and warm-up {build_s:.1f} s): "
                     f"{res.packets} packets in {res.seconds:.3f} s = "
                     f"{rec['pps']:.1f} packets/s; veto rate by phase "
                     + ", ".join(f"{ph}: {r:.4f}" for ph, r in rec["veto_rate"].items())
                     + (f"; triggers at ticks {rec['triggers']} ({rec['fired_on']}), installs "
                        f"at {rec['install_ticks']}, drift path {rec['drift_ms']:.3f} ms per "
                        f"tick (max {rec['drift_ms_max']:.3f}), epoch ms "
                        + ", ".join(f"{e:.2f}" for e in rec["epoch_ms"]) + ", install µs "
                        + ", ".join(f"{u:.1f}" for u in rec["install_us"])
                        if loop is not None else ""))
        del dep, eng, loop, res
        torch.cuda.empty_cache()
    pps = {mode: [r["pps"] for r in rs] for mode, rs in runs.items()}
    log("adapt", f"full width: {len(warmed)} widths warmed per engine, no capture after "
                 f"warm-up, no eviction, S pinned and no flip in all six runs; packets/s by mode "
                 + "; ".join(f"{m} " + ", ".join(f"{v:.1f}" for v in vs) for m, vs in pps.items())
                 + "; each loop run over the mean of the runs with no loop: "
                 + ", ".join(f"{v / np.mean(pps['no loop']):.3f}"
                             for m in ("sync loop", "async loop") for v in pps[m]))
    return runs


def tiny_program(device, backend=None):
    """The CPU tests' tiny classifier (the red-team harness's, port weights
    from seed 0) compiled against the canonical schedule's signature."""
    from repro_torch.compile import compile_program
    from repro_torch.optim.optimizer import tree_map
    from repro_torch.serve import redteam as R
    from repro_torch.train import classifier as C

    ccfg, params = R._build_classifier(device="cpu")
    sig = tiny_scenario().phase_anomaly_signature(0)
    return compile_program(ccfg, tree_map(lambda t: t.to(device), params), backend=backend,
                           verify=False,
                           rules=lambda c: C.default_rules(c, sig, device=device))


def tiny_scenario(**kw):
    from repro_torch.data.pipeline import DriftPhase, DriftScenario

    return DriftScenario(phases=(
        DriftPhase(kind="protocol-mix", batches=4, anomaly_rate=0.3),
        DriftPhase(kind="rule-violating", batches=6, anomaly_rate=0.6, sig_rotation=1),
        DriftPhase(kind="heavy-churn", batches=4, anomaly_rate=0.3, sig_rotation=1),
    ), pkt_len=8, packets_per_batch=48, seed=11, **kw)


def tiny_loop(program, device, fused, **kw):
    from repro_torch.serve.adaptive_loop import AdaptiveLoop, DriftPolicy
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig

    eng = program.deploy(DeploySpec(flow=FlowEngineConfig(fused=fused, **TINY_FLOW),
                                    device=device))
    return AdaptiveLoop(eng, policy=DriftPolicy(**TINY_POLICY), **kw)


def hold_histories(what, got, want):
    if len(got.history) != len(want.history):
        fail(f"{what}: {len(got.history)} adaptations vs {len(want.history)}")
    worst = 0.0
    for a, b in zip(got.history, want.history):
        for f in HISTORY_FIELDS:
            if getattr(a, f) != getattr(b, f):
                metrics = ", ".join(f"{k} {a.trigger[k]:.6f} / {b.trigger[k]:.6f} (threshold "
                                    f"{TINY_POLICY.get(k, 0.0)})" for k in a.trigger)
                fail(f"{what}: {f} differs at tick {b.tick}: {getattr(a, f)} vs "
                     f"{getattr(b, f)}; metrics card / CPU: {metrics}")
        worst = max([worst] + [abs(a.trigger[k] - b.trigger[k]) for k in b.trigger])
    for x, y in zip(got.engine.rules.tensors(), want.engine.rules.tensors()):
        if not torch_equal(x, y):
            fail(f"{what}: the installed tables differ")
    return worst


def torch_equal(a, b):
    import torch

    return torch.equal(a.cpu(), b.cpu())


def adapt_card_vs_cpu():
    """(b) The canonical drift replay of the CPU tests under sync loops:
    the fused engine on the card against the per-round engine on the CPU,
    float and int-emulation; then an async epoch held over a fresh CUDA
    graph capture."""
    import threading

    import torch
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.serve import adaptive_loop as AL
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig

    rec = {}
    # --- float ---------------------------------------------------------
    card_loop = tiny_loop(tiny_program("cuda"), "cuda", True)
    cpu_loop = tiny_loop(tiny_program("cpu"), "cpu", False)
    sc = tiny_scenario()
    margins = RoundMargins(cpu_loop.engine)
    worst = {k: 0.0 for k in FLOATS}
    batches, outs = [], []
    for i in range(sc.batches_per_cycle):
        b = sc.next_batch()
        got = card_loop.ingest(b["flow_ids"], b["tokens"])
        with margins:
            want = cpu_loop.ingest(b["flow_ids"], b["tokens"])
        errs = hold_outputs(f"adapt tiny float batch {i}: card vs CPU", got, want, ADAPT_TOL,
                            margins.margins())
        worst = {k: max(worst[k], errs[k]) for k in FLOATS}
        batches.append(b)
        outs.append(got)
    card_loop.close()
    cpu_loop.close()
    hold_invariants("adapt tiny float (card)", batches, outs)
    hold_loop("adapt tiny float (card)", card_loop)
    dm = hold_histories("adapt tiny float", card_loop, cpu_loop)
    rec["triggers"] = card_loop.trigger_ticks
    log("adapt", f"tiny width (d 32, capacity 512, lanes 16), 14 batches of the canonical "
                 f"schedule under sync loops, fused on the card vs per-round on the CPU: "
                 f"triggers {card_loop.trigger_ticks} "
                 f"({[list(r.fired_on) for r in card_loop.history]}), installs "
                 f"{card_loop.installs}, histories and installed tables identical (metrics max "
                 f"diff {dm:.2e}), decisions identical, max diffs "
                 + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    # --- int-emulation ---------------------------------------------------
    card_loop = tiny_loop(tiny_program("cuda", "int-emulation"), "cuda", True)
    cpu_loop = tiny_loop(tiny_program("cpu", "int-emulation"), "cpu", False)
    sc = tiny_scenario()
    boundary, moved, n = set(), 0, 0
    for i in range(sc.batches_per_cycle):
        b = sc.next_batch()
        got = card_loop.ingest(b["flow_ids"], b["tokens"])
        want = cpu_loop.ingest(b["flow_ids"], b["tokens"])
        for k in ("vetoed", "sig"):
            if not (got[k] == want[k]).all():
                fail(f"adapt tiny int batch {i}: {k} differs card vs CPU")
        hold_invariants(f"adapt tiny int batch {i}", [b], [got])
        ge, we = card_loop.engine, cpu_loop.engine
        ghs, whs = ge.hidden_sum.cpu().numpy().astype(np.int64), we.hidden_sum.numpy()
        for fid, slot in we.table.slot_of.items():
            d = np.abs(ghs[slot] - whs[slot])
            if (d > we.positions[slot].item()).any():
                fail(f"adapt tiny int: flow {fid}'s hidden_sum differs by more than one LSB "
                     f"per token")
            if d.any():
                boundary.add(fid)
        diff = np.zeros(len(b["flow_ids"]), bool)
        for k in ("trust", "s_nn", "s_sym", "pred"):
            diff |= got[k] != want[k]
        edge = np.array([f in boundary for f in b["flow_ids"].tolist()], bool)
        if (diff & ~edge).any():
            fail(f"adapt tiny int batch {i}: quantized scores differ off the boundary flows")
        moved += int(diff.sum())
        n += len(diff)
    card_loop.close()
    cpu_loop.close()
    hold_histories("adapt tiny int", card_loop, cpu_loop)
    if not torch_equal(card_loop.engine._int_tables["rule_w"],
                       cpu_loop.engine._int_tables["rule_w"]):
        fail("adapt tiny int: the re-lowered rule_w differs card vs CPU")
    log("adapt", f"tiny width int-emulation, same replay: triggers {card_loop.trigger_ticks}, "
                 f"installs {card_loop.installs}, histories identical, decisions identical, "
                 f"quantized scores identical but on {moved} of {n} packets "
                 f"({len(boundary)} boundary flows)")

    # --- an async epoch over a fresh capture -------------------------------
    # the engine is warmed at pkt_len 8; after the fire, a batch of 4-token
    # packets makes the engine capture new graphs, and the epoch is held to
    # run while the main thread is inside that capture
    marks, capture_started = {}, threading.Event()

    def relearn(loop, trigger, fired):
        if not capture_started.wait(120):
            fail("adapt overlap: no capture began while the epoch waited")
        marks["epoch_start"] = time.perf_counter()
        return AL.default_relearn(loop, trigger, fired)  # recluster + compile_delta follow

    card_loop = tiny_loop(tiny_program("cuda"), "cuda", True, relearn=relearn,
                          cfg=AL.AdaptiveLoopConfig(sync=False))
    eng = card_loop.engine
    eng.warm_fused(8)
    graphs = eng._graphs
    run_body = graphs._run_body

    def body(inp):
        if (torch.cuda.is_current_stream_capturing() and card_loop._pending is not None
                and "capture_start" not in marks):
            marks["capture_start"] = time.perf_counter()
            capture_started.set()
            card_loop._pending[0].result(timeout=120)  # the epoch runs during the capture
            marks["epoch_end"] = time.perf_counter()
        return run_body(inp)

    graphs._run_body = body
    cpu_eng = tiny_program("cpu").deploy(DeploySpec(flow=FlowEngineConfig(**TINY_FLOW),
                                                    device="cpu"))
    sc = tiny_scenario()
    short = FlowScenario(kind="rule-violating", pkt_len=4, packets_per_batch=48, seed=11,
                         sig_rotation=1, fid_base=1 << 40)
    plan = [sc.next_batch() for _ in range(sc.batches_per_cycle)]
    plan = plan[:8] + [short.next_batch(), short.next_batch()] + plan[8:11]
    card_outs = []
    n_graphs0 = len(eng.fused_graphs())
    for b in plan:
        card_outs.append(card_loop.ingest(b["flow_ids"], b["tokens"]))
    card_loop.close()
    graphs._run_body = run_body
    if len(card_loop.history) != 1 or not card_loop.history[0].installed:
        fail(f"adapt overlap: expected one installed epoch, got {card_loop.history}")
    r = card_loop.history[0]
    overlap = ("capture_start" in marks and marks["capture_start"] <= marks["epoch_start"]
               <= marks["epoch_end"])
    if not overlap:
        fail(f"adapt overlap: the epoch did not run inside a capture ({marks})")
    new_graphs = len(eng.fused_graphs()) - n_graphs0
    # the same traffic on the CPU with the install at the same tick boundary
    for i, b in enumerate(plan):
        if i == r.install_tick:
            cpu_eng.swap_tables(ruleset=card_loop.host_rules)
        want = cpu_eng.ingest(b["flow_ids"], b["tokens"])
        hold_outputs(f"adapt overlap batch {i}: card (async loop) vs CPU", card_outs[i], want,
                     ADAPT_TOL)
    hold_invariants("adapt overlap", plan, card_outs)
    rec["overlap"] = overlap
    log("adapt", f"async epoch inside a fresh capture: fired at tick {r.tick}, the epoch ran "
                 f"inside the capture of a 4-token width ({new_graphs} new graphs, epoch "
                 f"{1e3 * r.epoch_s:.2f} ms), installed at the boundary after tick "
                 f"{r.install_tick}; every batch equal to the CPU engine with the same install "
                 f"at the same boundary (decisions identical, floats within {ADAPT_TOL:g})")
    return rec


def adapt_gate():
    """(c) The red-team gate (the smoke campaign in its three modes and the
    sample-trace replay) with the port's own weights, on the card and on
    the CPU: every deterministic scorecard field identical."""
    from repro_torch.data.campaigns import SMOKE_CAMPAIGN
    from repro_torch.serve import redteam as R

    cards = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        cards[dev] = R.run_redteam([SMOKE_CAMPAIGN], R.RedTeamConfig(device=dev))
        log("adapt", f"red-team gate on {dev} in {time.perf_counter() - t0:.1f} s:")
        for c in cards[dev]:
            print("        " + R._summary_line(c), flush=True)
            for msg in c.failures:
                print(f"            {msg}", flush=True)
    bad = 0
    for a, b in zip(cards["cuda"], cards["cpu"]):
        bad += a.pinning_violations + a.veto_flips + a.evictions
        da, db = a.as_dict(), b.as_dict()
        for k in ("wall_s", "installs_per_hour"):
            da.pop(k)
            db.pop(k)
        for k in sorted(db):
            if da[k] != db[k]:
                fail(f"adapt gate {a.campaign}: scorecard field {k!r} differs card vs CPU: "
                     f"{da[k]} vs {db[k]}")
    if bad:
        fail(f"adapt gate: {bad} pinning violations, veto flips or evictions on the card")
    verdict = all(c.passed for c in cards["cuda"])
    log("adapt", f"red-team gate {'PASSED' if verdict else 'FAILED (shared by the CPU run)'}: "
                 f"card = CPU on every deterministic field; recovery by phase "
                 + str([p.recovery for p in cards["cuda"][0].phases]))
    return {"passed": verdict, "invariant_violations": bad,
            "wall_s": {d: sum(c.wall_s for c in cs) for d, cs in cards.items()}}


def phase_adapt():
    """The closed adaptation loop on the card, run after the program phase,
    with the launch counters zeroed just before and read just after."""
    from repro_torch.kernels.flow_ingest import fused as fmod

    counted = ("decode_step", "flow_score", "int_flow_score")
    for name in counted:
        fmod.COUNTED[name].launches = 0
    rec = {"full": adapt_full_width(), "tiny": adapt_card_vs_cpu(), "gate": adapt_gate()}
    launched = {name: fmod.COUNTED[name].launches for name in counted}
    if min(launched.values()) == 0:
        fail(f"adapt: a kernel was never launched on the adapt phase's path: {launched}")
    log("adapt", f"launches on the adapt phase's path: {launched}")
    rec["launches"] = launched
    return rec


# --------------------------------------------------------------------------
# 10. shard: sharded and elastic flow serving, N logical shards on the card
# --------------------------------------------------------------------------

SHARDS = 4  # logical shards of the paper-width sharded engine
# floats of one launch over S x lanes rows against launches over lanes rows
# (cuBLAS picks its kernels by row count).  Set between the sound readings
# of (a) and its control, the same stacked launch with TF32 matmuls
# allowed, which the limit must catch (the phase fails if it does not): on
# an H100 80GB HBM3 at 700 W, at 2 layers up to 4.5e-05 sound and 1.5e-02
# under TF32 (both s_nn; at 4 layers 3.8e-05 and 6.3e-02; PERF.md section 6)
SHARD_TOL = 1e-4
N_TIMED = 4  # protocol-mix batches timed in (a), the two engines taking turns first
# (a) runs the paper's width at 2 of its 4 layers, so that the whole run
# stays within ~925 s (on an H100 it took 925.3 s with 4, once two more LM
# configs were served; PERF.md section 6): sharded and single engines are
# compared layer for layer alike, at half the host-bound per-round time
SHARD_LAYERS = 1  # a depth cut (PERF.md section 4)
ELASTIC_ARGS = ["--elastic", "--num-shards", "2", "--reshard", "4:4,8:2", "--batches", "12",
                "--scenario", "rule-violating", "--packets", "64", "--pkt-len", str(PKT_LEN),
                "--capacity", "1024", "--lanes", str(LANES)]


def shard_paper_width():
    """(a) A ShardedFlowEngine of SHARDS logical shards x CAPACITY / SHARDS
    slots (lanes 256 per shard) beside a per-round FlowEngine (capacity
    CAPACITY, lanes 256), both on the card with the paper classifier's
    seed-0 weights at SHARD_LAYERS of its layers, on the same protocol-mix
    and rule-violating batches, held to each other within SHARD_TOL.  Then the control: the sharded
    engine, reset, takes the first two batches again with TF32 matmuls
    allowed, and its distance from the single engine is read."""
    import torch
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.flow_ingest import fused as fmod
    from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig
    from repro_torch.serve.sharded_flow_engine import ShardedFlowEngine
    from repro_torch.train import classifier as C

    ccfg, params = paper_classifier(n_layers=SHARD_LAYERS)
    mix = FlowScenario(kind="protocol-mix", pkt_len=PKT_LEN, packets_per_batch=256, seed=SEED)
    bad = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=256,
                       seed=SEED, fid_base=1 << 32)
    rules = C.default_rules(ccfg, bad.anomaly_signature, device="cuda")
    plan = [("warm-up", mix.next_batch())] + [
        ("timed", mix.next_batch()) for _ in range(N_TIMED)] + [
        ("rule-violating", bad.next_batch())]
    # the profiled batch: the first 64 packets of the next protocol-mix
    # batch (flows already resident, so their rings are as full as the timed
    # batches'; fewer rounds keep the profiler's cost down)
    profiled = {k: v[:64] for k, v in mix.next_batch().items()}
    budget = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    sharded = ShardedFlowEngine(ccfg, params, rules, FlowEngineConfig(
        capacity=CAPACITY // SHARDS, lanes=LANES, state_budget_bytes=budget),
        num_shards=SHARDS, device="cuda")
    single = FlowEngine(ccfg, params, rules, FlowEngineConfig(
        capacity=CAPACITY, lanes=LANES, state_budget_bytes=budget), device="cuda")
    log("shard", f"(a) {SHARDS} shards x {CAPACITY // SHARDS} slots (aggregate "
                 f"{sharded.aggregate_capacity}, {sharded.resident_state_bytes()} B) beside one "
                 f"engine of {CAPACITY} slots ({single.resident_state_bytes()} B), lanes {LANES} "
                 f"per shard, built in {time.perf_counter() - t0:.2f} s")
    margins = RoundMargins(single)
    wall = {"sharded": 0.0, "single": 0.0}
    n_timed, worst, vetoes, ratios, wants = 0, {k: 0.0 for k in FLOATS}, 0, [], []
    counts = {"decode_step": 0, "flow_score": 0, "rounds": 0}

    def run_sharded(b):
        before = {n: fmod.COUNTED[n].launches for n in ("decode_step", "flow_score")}
        rounds0 = sharded.stats.rounds
        t0 = time.perf_counter()
        got = sharded.ingest(b["flow_ids"], b["tokens"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for n in before:
            counts[n] += fmod.COUNTED[n].launches - before[n]
        counts["rounds"] += sharded.stats.rounds - rounds0
        return got, dt

    def run_single(b):
        with margins:
            t0 = time.perf_counter()
            want = single.ingest(b["flow_ids"], b["tokens"])
            torch.cuda.synchronize()
            return want, time.perf_counter() - t0, margins.margins()

    for i, (kind, b) in enumerate(plan):
        if i % 2:  # the engines take turns going first
            want, t_single, mg = run_single(b)
            got, t_sharded = run_sharded(b)
        else:
            got, t_sharded = run_sharded(b)
            want, t_single, mg = run_single(b)
        wants.append(want)
        errs = hold_outputs(f"shard (a) batch {i} ({kind}): sharded vs single", got, want,
                            SHARD_TOL, mg)
        worst = {k: max(worst[k], errs[k]) for k in FLOATS}
        if kind == "timed":
            wall["sharded"] += t_sharded
            wall["single"] += t_single
            n_timed += len(b["flow_ids"])
            ratios.append(t_single / t_sharded)
        vetoes += int(got["vetoed"].sum())
    st, sst = sharded.stats, single.stats
    if (st.flows_created, st.flows_evicted, st.packets) != (
            sst.flows_created, sst.flows_evicted, sst.packets):
        fail(f"shard (a): flow counts differ, sharded {st} vs single {sst}")
    if sorted(sharded.flow_ids()) != sorted(single.flow_ids()):
        fail("shard (a): the resident flows differ")
    if vetoes == 0:
        fail("shard (a): no packet was vetoed")
    shard_rows = {s: n for s, n in enumerate(sharded.resident_flows_per_shard())}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sharded.ingest(profiled["flow_ids"], profiled["tokens"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, _ = report_profile(prof, prof_wall, f"shard (a): one protocol-mix batch of "
                             f"{len(profiled['flow_ids'])} packets, sharded")
    pps = {k: n_timed / v for k, v in wall.items()}
    per_round = {n: counts[n] / counts["rounds"] for n in ("decode_step", "flow_score")}
    log("shard", f"(a) decisions identical on {len(plan)} batches ({vetoes} vetoes, "
                 f"{st.flows_created} flows, {st.flows_evicted} evictions on both; pred where the "
                 f"top-2 margin exceeds {REF_PRED_MARGIN:g}); max diffs sharded vs single "
                 + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                 + f" (limit {SHARD_TOL:g}); timed protocol-mix: {n_timed} packets in {N_TIMED} "
                 f"batches, sharded {pps['sharded']:.1f} packets/s, single {pps['single']:.1f} "
                 f"packets/s, sharded/single per batch " + ", ".join(f"{r:.3f}" for r in ratios)
                 + f"; rounds {counts['rounds']} sharded vs {sst.rounds} single; launches per "
                 f"sharded round " + ", ".join(f"{n} {v:.1f}" for n, v in per_round.items())
                 + f"; busy share {'not measured' if busy is None else f'{busy / prof_wall / 1e3:.3f}'}")
    log("shard", f"(a) resident flows per shard {shard_rows}")

    # the control: what the limit is set to catch, a lower-precision stacked launch
    control = {k: 0.0 for k in FLOATS}
    flips = 0
    sharded.reset()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for (kind, b), want in zip(plan[:2], wants):
            got = sharded.ingest(b["flow_ids"], b["tokens"])
            control = {k: max(control[k], float(np.abs(got[k] - want[k]).max())) for k in FLOATS}
            flips += int((got["vetoed"] != want["vetoed"]).sum())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if max(control.values()) <= SHARD_TOL:
        fail(f"shard (a): the TF32 control stays within SHARD_TOL {SHARD_TOL:g}: {control}")
    log("shard", f"(a) control, the first 2 batches again with TF32 matmuls allowed: max diffs "
                 f"sharded vs single " + ", ".join(f"{k} {v:.3e}" for k, v in control.items())
                 + f", {flips} veto flips; the limit {SHARD_TOL:g} catches it")
    return {"pps": pps, "ratios": ratios, "worst": worst, "control": control,
            "per_round": per_round, "counts": counts,
            "busy": None if busy is None else busy / prof_wall / 1e3}


def shard_elastic():
    """(b) The elastic service through the port's launcher (build and serve)
    at the paper's width, FLOW_LAYERS of its layers: 2 shards, reshard 2 -> 4 -> 2 over 12 rule-violating
    batches, checkpoints every 6 ticks into a temporary directory; beside it a
    service with no checkpoint directory on the same batches, never killed.
    Then 2 more batches, the first service loses shard 1 and recovers (from
    its in-memory checkpoint), and one more batch: every flow's decisions
    and scores equal the other's.  A fresh service then restores the newest
    checkpoint from disk, held to the in-memory one bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.checkpointer import flatten_with_names
    from repro_torch.launch import flow_serve as F
    from repro_torch.serve.deploy import ElasticConfig
    from repro_torch.serve.elastic import ElasticFlowService, snapshot_flow_state

    ccfg, params = paper_classifier(n_layers=FLOW_LAYERS)
    budget = torch.cuda.mem_get_info()[0] // 4
    tmp = tempfile.mkdtemp(prefix="chimera-elastic-")
    try:
        deps, results = {}, {}
        for label, extra in (("service", ["--checkpoint-dir", tmp, "--checkpoint-every", "6"]),
                             ("never killed", [])):
            args = F.parse_args(ELASTIC_ARGS + extra + ["--state-budget-bytes", str(budget)])
            t0 = time.perf_counter()
            dep = deps[label] = F.build(args, params=params, arch=ccfg.arch)
            if dep.program.ccfg.arch != ccfg.arch:
                fail("shard (b): the launcher's arch is not the paper classifier's")
            build_s = time.perf_counter() - t0
            saves = []
            if dep.engine._ckpt is not None:
                real_save = dep.engine._ckpt.save

                def save(step, tree, extra=None, blocking=False, _real=real_save, _saves=saves):
                    nbytes = sum(np.asarray(x).nbytes for x in flatten_with_names(tree)[1])
                    t1 = time.perf_counter()
                    _real(step, tree, extra=extra, blocking=blocking)
                    _saves.append((extra["elastic"]["kind"], nbytes, time.perf_counter() - t1))

                dep.engine._ckpt.save = save
            res = results[label] = F.serve(dep, keep=True)
            hold_invariants(f"shard (b) {label}", res.batches, res.outputs)
            for line in F.report(dep, res):
                log("shard", f"(b) {label}: {line}")
            log("shard", f"(b) {label}: compile and deploy {build_s:.3f} s; " + "; ".join(
                f"reshard @batch {i} {r.old_shards}->{r.new_shards}: {r.migrated_flows} flows "
                f"migrated, {r.moved_flows} moved, install {r.install_s * 1e3:.3f} ms, "
                f"churn_ok {r.churn_ok}" for i, r in res.reshards))
            if not all(r.churn_ok and not r.rolled_back for _, r in res.reshards):
                fail(f"shard (b) {label}: a reshard was rolled back")
            if saves:
                log("shard", f"(b) {label}: checkpoints " + "; ".join(
                    f"{kind} {nbytes} B in {sec:.3f} s" for kind, nbytes, sec in saves))
        svc, ref = deps["service"].engine, deps["never killed"].engine
        worst = {k: 0.0 for k in FLOATS}
        for i, (a, b) in enumerate(zip(results["service"].outputs, results["never killed"].outputs)):
            errs = hold_outputs(f"shard (b) batch {i}: service vs never killed", a, b, SHARD_TOL)
            worst = {k: max(worst[k], errs[k]) for k in FLOATS}
        for _ in range(2):  # past the last checkpoint (tick 12): the replay window's work
            b = deps["service"].scenario.next_batch()
            if not np.array_equal(b["tokens"], deps["never killed"].scenario.next_batch()["tokens"]):
                fail("shard (b): the two launchers' scenarios diverged")
            hold_outputs("shard (b) after the checkpoint", svc.ingest(b["flow_ids"], b["tokens"]),
                         ref.ingest(b["flow_ids"], b["tokens"]), SHARD_TOL)
        lost = svc.kill_shard(1)
        t0 = time.perf_counter()
        rec = svc.recover()
        recover_s = time.perf_counter() - t0
        if svc.dead_shards() or svc.num_shards != 1 or not lost:
            fail(f"shard (b): recovery left shards {svc.dead_shards()} of {svc.num_shards}")
        b = deps["service"].scenario.next_batch()
        deps["never killed"].scenario.next_batch()
        errs = hold_outputs("shard (b) after recovery", svc.ingest(b["flow_ids"], b["tokens"]),
                            ref.ingest(b["flow_ids"], b["tokens"]), SHARD_TOL)
        worst = {k: max(worst[k], errs[k]) for k in FLOATS}
        if sorted(svc.flow_ids()) != sorted(ref.flow_ids()):
            fail("shard (b): the recovered service's flows differ from the never-killed one's")
        flow_worst = {k: 0.0 for k in FLOATS}
        for fid in ref.flow_ids():
            g, w = svc.flow_scores(fid), ref.flow_scores(fid)
            if (g["vetoed"], g["tokens"], g["pred"]) != (w["vetoed"], w["tokens"], w["pred"]):
                fail(f"shard (b): flow {fid} after recovery {g} vs never killed {w}")
            flow_worst = {k: max(flow_worst[k], abs(g[k] - w[k])) for k in FLOATS}
        if max(flow_worst.values()) > SHARD_TOL:
            fail(f"shard (b): flow scores after recovery differ by {flow_worst}")
        vetoed = sum(svc.flow_scores(f)["vetoed"] for f in ref.flow_ids())
        if not vetoed:
            fail("shard (b): no flow was vetoed, so no sticky veto bit crossed the recovery")
        # recover() took the checkpoint from memory; the disk path: a fresh
        # service restores the newest checkpoint on disk, which must hold
        # the in-memory snapshot's rows bit for bit
        mem_snap, mem_meta = svc._last_ckpt
        t0 = time.perf_counter()
        fresh = ElasticFlowService(deps["service"].program, svc.fcfg,
                                   ElasticConfig(checkpoint_dir=tmp), num_shards=2, device="cuda")
        step = fresh.restore_checkpoint()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        disk_names, disk_leaves = flatten_with_names(snapshot_flow_state(fresh.engine))
        mem_names, mem_leaves = flatten_with_names(mem_snap)
        if disk_names != mem_names or not all(
                np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(disk_leaves, mem_leaves)):
            fail("shard (b): the checkpoint restored from disk differs from the in-memory snapshot")
        if fresh.engine._tick != mem_meta["tick"]:
            fail(f"shard (b): restored tick {fresh.engine._tick} vs {mem_meta['tick']}")
        log("shard", f"(b) disk restore: a fresh 2-shard service loaded checkpoint step {step} "
                     f"({len(mem_snap['fids'])} flows, tick {mem_meta['tick']}) in {restore_s:.3f} "
                     f"s (deploy included); its rows equal the in-memory snapshot's bit for bit")
        del fresh
        log("shard", f"(b) kill shard 1 ({len(lost)} flows lost) and recover: {rec.old_shards}->"
                     f"{rec.new_shards} shards, {rec.restored_flows} flows restored from the "
                     f"in-memory checkpoint at tick {mem_meta['tick']}, {rec.replayed_packets} "
                     f"packets replayed, install {rec.install_s * 1e3:.3f} ms, recover "
                     f"{recover_s:.3f} s; then every flow ({len(ref.flow_ids())}, {vetoed} vetoed) "
                     f"equals the never-killed service's: vetoes, tokens, pred identical, max "
                     f"diffs " + ", ".join(f"{k} {v:.3e}" for k, v in flow_worst.items())
                     + "; outputs over the run " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        out = {"reshards": [r.as_dict() for _, r in results["service"].reshards],
               "recover_s": recover_s, "recover": rec.as_dict(), "restore_s": restore_s,
               "pps": {k: r.packets_per_s for k, r in results.items()}}
        del deps, svc, ref
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard_int_emulation():
    """(c) int-emulation sharded (SHARDS shards x 32 slots, lanes 16) at the
    smoke width (the program phase's program), on the card against the CPU,
    with a swap_tables(delta=...) after batch 2."""
    import dataclasses

    import torch
    from repro_torch.compile import compile_delta, compile_program
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig
    from repro_torch.train import classifier as C

    arch = dataclasses.replace(smoke_config("chimera-dataplane"), vocab_size=512)
    sccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256)
    sparams = C.init_classifier(sccfg, torch.Generator().manual_seed(SEED + 60), device="cpu")
    sc = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=48,
                      seed=SEED + 61)
    iprog = compile_program(sccfg, sparams, backend="int-emulation", verify=False,
                            rules=lambda c: C.default_rules(c, sc.anomaly_signature, device="cpu"))
    delta = compile_delta(iprog, weights=[-2.5], step=1)
    engs = {dev: iprog.deploy(DeploySpec(engine="sharded", num_shards=SHARDS, device=dev,
                                         flow=FlowEngineConfig(capacity=32, lanes=16,
                                                               state_budget_bytes=1 << 40)))
            for dev in ("cuda", "cpu")}
    boundary, moved, n, vetoes = set(), 0, 0, 0
    for i in range(4):
        b = sc.next_batch()
        if i == 2:
            for e in engs.values():
                e.swap_tables(delta=delta)
        got, want = (engs[d].ingest(b["flow_ids"], b["tokens"]) for d in ("cuda", "cpu"))
        ge, we = engs["cuda"], engs["cpu"]
        for k in ("vetoed", "sig"):
            if not (got[k] == want[k]).all():
                fail(f"shard (c) batch {i}: {k} differs card vs CPU")
        if not ((got["trust"] == 1.0) == got["vetoed"]).all():
            fail(f"shard (c) batch {i}: trust == 1.0 is not exactly the veto")
        if ge.stats != we.stats or [t.slot_of for t in ge.tables] != [t.slot_of for t in we.tables]:
            fail(f"shard (c) batch {i}: stats or slots differ card vs CPU")
        ghs = ge.hidden_sum.cpu().numpy().astype(np.int64)
        whs = we.hidden_sum.numpy().astype(np.int64)
        for s, t in enumerate(we.tables):
            for fid, slot in t.slot_of.items():
                d = np.abs(ghs[s, slot] - whs[s, slot])
                if (d > int(we.positions[s, slot])).any():
                    fail(f"shard (c): flow {fid}'s hidden_sum differs by more than one LSB per "
                         f"token card vs CPU")
                if d.any():
                    boundary.add(fid)
        diff = np.zeros(len(b["flow_ids"]), bool)
        for k in ("trust", "s_nn", "s_sym", "pred"):
            diff |= got[k] != want[k]
        edge = np.array([f in boundary for f in b["flow_ids"].tolist()], bool)
        if (diff & ~edge).any():
            fail(f"shard (c) batch {i}: quantized scores differ on a flow whose accumulator "
                 f"does not")
        moved += int(diff.sum())
        n += len(diff)
        vetoes += int(got["vetoed"].sum())
    if not torch.equal(engs["cuda"]._int_tables["rule_w"].cpu(), engs["cpu"]._int_tables["rule_w"]):
        fail("shard (c): the re-lowered rule_w differs card vs CPU")
    log("shard", f"(c) int-emulation, {SHARDS} shards at the smoke width (d 64), 4 rule-violating "
                 f"batches ({n} packets, {vetoes} vetoes), swap_tables(delta) after batch 2, card "
                 f"vs CPU: decisions, slots and stats identical, quantized scores identical but "
                 f"on {moved} packets ({len(boundary)} flows whose int32 hidden_sum moved by a "
                 f"rounding LSB)")
    return {"moved": moved, "packets": n, "boundary_flows": len(boundary)}


def scratch_scatter_check():
    """The flow step's scatter at the sharded width: every shard's padding
    lanes write its one scratch row (duplicate indices), its real lanes
    distinct rows.  Real rows must get exactly their lanes' values, by
    default and under ``torch.use_deterministic_algorithms`` (reported, not
    held, if that mode refuses the scatter)."""
    import torch

    S, n_slots, d = SHARDS, CAPACITY // SHARDS + 1, 256
    g = torch.Generator().manual_seed(SEED + 90)
    idx = torch.arange(S)[:, None].repeat(1, LANES) * n_slots + (n_slots - 1)
    real = torch.randperm(n_slots - 1, generator=g)[:LANES // 2]
    idx[:, : LANES // 2] = torch.arange(S)[:, None] * n_slots + real
    idx = idx.reshape(-1).cuda()
    rows = torch.randn((S * LANES, d), generator=g).cuda()
    keep = torch.ones((S, LANES), dtype=torch.bool)
    keep[:, LANES // 2:] = False
    keep = keep.reshape(-1).cuda()
    outs = {}
    for mode in ("default", "deterministic"):
        t = torch.zeros((S * n_slots, d), device="cuda")
        torch.use_deterministic_algorithms(mode == "deterministic")
        try:
            t[idx] = rows
            torch.cuda.synchronize()
        except RuntimeError as e:
            outs[mode] = f"raises: {str(e)[:120]}"
            continue
        finally:
            torch.use_deterministic_algorithms(False)
        if not torch.equal(t[idx[keep]], rows[keep]):
            fail(f"shard: the {mode} scatter wrote wrong values into real rows")
        outs[mode] = t
    same = (torch.equal(outs["default"], outs["deterministic"])
            if not isinstance(outs["deterministic"], str) else outs["deterministic"])
    log("shard", f"scatter with {S * (LANES - LANES // 2)} padding lanes on {S} scratch rows: real "
                 f"rows exact; under use_deterministic_algorithms the table equals the default "
                 f"scatter's: {same}")


def phase_shard():
    """Sharded and elastic flow serving on one card: (a) the paper's width,
    sharded beside single; (b) the elastic service through the launcher,
    resharded, checkpointed, a shard killed and recovered; (c) sharded
    int-emulation card vs CPU.  The stacked-width decode_step and flow_score
    are held against their plain versions and timed first; then the kernels' launch
    counters are zeroed, and each part fails if a kernel of its path never
    launched."""
    from repro_torch.kernels.flow_ingest import fused as fmod

    stacked = check_decode(with_global=True, timed=True, B=SHARDS * LANES)
    log("shard", f"decode_step at the stacked width ({SHARDS} x {LANES} lanes x 4 kv-heads = "
                 f"{SHARDS * LANES * 4} rows): {stacked['ms']:.4f} ms per launch, bound "
                 f"{stacked['bound_ms']:.4f} ms by {stacked['bound_by']}, plain "
                 f"{stacked['plain_ms']:.4f} ms")
    # default_rules' one rule; the paper classifier's 8 classes, 8 words
    score = check_score(M=1, timed=True, B=SHARDS * LANES)
    log("shard", f"flow_score at the stacked width ({SHARDS} x {LANES} lanes = "
                 f"{SHARDS * LANES} rows): {score['ms']:.5f} ms per launch, launch floor "
                 f"{score['floor_ms']:.5f} ms, bound {score['bound_ms']:.6f} ms by "
                 f"{score['bound_by']}, plain {score['plain_ms']:.4f} ms")
    scratch_scatter_check()
    counted = ("decode_step", "flow_score", "int_flow_score")
    rec, launched = {"decode_stacked": stacked, "score_stacked": score}, {}
    for part, fn, needs in (("paper", shard_paper_width, ("decode_step", "flow_score")),
                            ("elastic", shard_elastic, ("decode_step", "flow_score")),
                            ("int", shard_int_emulation, ("int_flow_score",))):
        for name in counted:
            fmod.COUNTED[name].launches = 0
        t0 = time.perf_counter()
        rec[part] = fn()
        launched[part] = {name: fmod.COUNTED[name].launches for name in counted}
        log("shard", f"{part} part: {time.perf_counter() - t0:.1f} s")
        if min(launched[part][name] for name in needs) == 0:
            fail(f"shard: a kernel was never launched on the {part} part's path: "
                 f"{launched[part]}")
    rec["launches"] = {name: sum(p[name] for p in launched.values()) for name in counted}
    log("shard", f"launches on the shard phase's path: {launched}")
    return rec


# --------------------------------------------------------------------------
# 12. trainer (the Trainer and launch/train.py)
# --------------------------------------------------------------------------

TRAINER_STEPS = 100  # launch/train.py's defaults: --batch 8 --seq 128 --steps 100
RESUME_STEPS = 10  # (b): 10 direct against 5 + 5 resumed
RESUME_TOL = 1e-6  # (b): final parameters, direct against resumed (deterministic mode)
CODEBOOK_STEPS, CODEBOOK_T_CP = 30, 10  # (c): installs at steps 10, 20 and 30
CODEBOOK_PACKETS, CODEBOOK_BATCHES = 48, 2  # (c): the deployed program, card against CPU
LM100M_STEPS = 20  # (d): timed steps after 1 warm-up
# (c) card against CPU: delta_map is a mean of relative centroid moves,
# computed on the host from features that carry the card's rounding, so it
# is held as the losses are; the installed centroids (means of those
# features) are held as the kernels' outputs are
CODEBOOK_DM_RTOL = REF_LOSS_RTOL
SMOKE_STEPS = 5  # the launcher's smoke config, card against CPU
# (c) the card's k-means against the CPU's on the same reservoir: a
# farthest-point pick may differ only where the CPU's largest distance
# exceeds the next smaller one by at most this (relative; the card sums
# each squared distance in another order), and the centroids of Lloyd's
# steps from the card's picks are held within KMEANS_ATOL
KMEANS_TIE_RTOL = 1e-6
KMEANS_ATOL = 1e-5


def lm_100m():
    """``examples/train_lm.py``'s ``lm_100m``: 12 layers, d 768, 12 heads,
    d_head 64, d_ff 2048, vocab 32000, exp_prf m 64, L 128, n_global 32, fp32."""
    import dataclasses

    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.core.chimera_attention import ChimeraAttentionConfig
    from repro_torch.core.feature_maps import FeatureMapConfig

    return dataclasses.replace(
        ARCH, name="chimera-lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_head=64, d_ff=2048, vocab_size=32000,
        chimera=ChimeraAttentionConfig(feature_map=FeatureMapConfig(kind="exp_prf", m=64),
                                       chunk_size=128, n_global=32),
        dtype="float32")


def codebook_arch(bits=0):
    """The paper's model with the codebook map (m 256, 256 centroids)."""
    import dataclasses

    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.core.feature_maps import FeatureMapConfig

    fm = FeatureMapConfig(kind="codebook", m=256, codebook_size=256, codebook_bits=bits)
    return dataclasses.replace(ARCH, chimera=dataclasses.replace(ARCH.chimera, feature_map=fm))


def trainer_for(arch, directory, steps, seed=SEED, lr=3e-4, warmup=100, device="cuda",
                batch=8, seq=128, params=None, stream=None, **tcfg):
    """A Trainer (on the card unless told) over ``stream``, else
    launch/train.py's stream (batch 8 x 128 unless given), from ``params``
    if given."""
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    tcfg = {"log_every": 1, "ckpt_every": 1000, **tcfg}
    if stream is None:
        stream = TokenStream(vocab_size=arch.vocab_size, batch_size=batch, seq_len=seq + 1,
                             seed=seed)
    return Trainer(arch, TrainerConfig(total_steps=steps, ckpt_dir=directory, **tcfg), stream,
                   opt_cfg=AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps),
                   device=device, params=params)


def timed_run(tr, steps):
    """``tr.run(steps)`` with a synchronize around it; returns ``(out, loop
    seconds, final save seconds)``: the loop's seconds leave out the
    blocking save that ends every run (host copy and write), timed apart."""
    import torch

    saves = []
    real = tr.save

    def save(blocking=False):
        t0 = time.perf_counter()
        real(blocking=blocking)
        if blocking:
            saves.append(time.perf_counter() - t0)

    tr.save = save
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tr.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del tr.save
    return out, wall - saves[-1], saves[-1]


def logged_losses(what, out):
    losses = [r["loss"] for r in out["log"]]
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{what}: losses {losses}")
    return losses


def param_diff(a, b):
    from repro_torch.optim.optimizer import tree_flatten

    return max(float((x - y).abs().max()) for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def trainer_launcher(cops):
    """(a) launch/train.py at its defaults on the paper's model."""
    import tempfile

    import torch
    from repro_torch.launch import train as LT

    with tempfile.TemporaryDirectory(prefix="chimera-train-") as tmp:
        base = torch.cuda.memory_allocated()  # what earlier phases still hold
        tr = LT.build(LT.parse_args(["--arch", "chimera-dataplane", "--ckpt-dir", tmp]))
        torch.cuda.reset_peak_memory_stats()
        cops.launches = cops.bwd_launches = 0
        warm, warm_s, _ = timed_run(tr, 1)
        out, loop_s, save_s = timed_run(tr, TRAINER_STEPS)
        launches, bwd = cops.launches, cops.bwd_launches
        peak = torch.cuda.max_memory_allocated()
        if launches == 0 or bwd == 0:
            fail(f"trainer (a): chimera_attention launched forward {launches}, backward {bwd}")
        t0 = time.perf_counter()
        tr.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if tr.step != TRAINER_STEPS:
            fail(f"trainer (a): restored step {tr.step}")
    losses = logged_losses("trainer (a)", out)
    timed_steps = TRAINER_STEPS - 1
    ms = loop_s / timed_steps * 1e3
    log("trainer", f"(a) launch/train.py --arch chimera-dataplane (batch 8 x 128, "
                   f"{TRAINER_STEPS} steps, lr 3e-4): step 1 {warm_s * 1e3:.1f} ms; steps 2-"
                   f"{TRAINER_STEPS} {ms:.2f} ms/step, {8 * 128 / (ms / 1e3):.0f} tokens/s "
                   f"(checkpoints every 25 steps inside the loop); loss step "
                   f"{out['log'][0]['step']} {losses[0]:.5f}, step {out['log'][-1]['step']} "
                   f"{losses[-1]:.5f}; final save {save_s:.3f} s, restore {restore_s:.3f} s; "
                   f"chimera_attention launches {launches} ({launches / TRAINER_STEPS:.1f} per "
                   f"step), its backward's {bwd}; max_memory_allocated {peak}, {peak - base} "
                   f"above the {base} B allocated before the part")
    return {"launches": launches, "bwd": bwd, "ms": ms, "loss": (losses[0], losses[-1]),
            "save_s": save_s, "restore_s": restore_s, "peak": peak - base}


def trainer_card_vs_cpu():
    """The launcher's smoke config, SMOKE_STEPS steps on the card and on the
    CPU from the same seed: losses within REF_LOSS_RTOL."""
    import tempfile

    from repro_torch.launch import train as LT

    losses = {}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory(prefix="chimera-train-") as tmp:
            args = LT.parse_args(["--smoke", "--steps", str(SMOKE_STEPS), "--device", dev,
                                  "--ckpt-dir", tmp])
            losses[dev] = logged_losses(f"trainer smoke {dev}", LT.build(args).run())
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    if err > REF_LOSS_RTOL:
        fail(f"trainer smoke: card and CPU losses differ by {err:.3e} > {REF_LOSS_RTOL:g}")
    log("trainer", f"smoke config, {SMOKE_STEPS} launcher steps, card (kernel) vs CPU (plain): "
                   f"losses max relative diff {err:.3e} (tolerance {REF_LOSS_RTOL:g})")


def trainer_resume(cops):
    """(b) 10 steps direct against 5 + 5 through a checkpoint, in
    deterministic mode (the embedding's backward otherwise adds with
    atomics in any order)."""
    import tempfile

    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH

    torch.use_deterministic_algorithms(True)  # cuBLAS's workspace is fixed in main()
    cops.launches = cops.bwd_launches = 0
    try:
        with tempfile.TemporaryDirectory(prefix="chimera-resume-") as tmp:
            kw = dict(lr=1e-3, warmup=2, seed=SEED + 1, ckpt_every=5)
            direct = trainer_for(ARCH, os.path.join(tmp, "a"), RESUME_STEPS, **kw)
            direct.run()
            first = trainer_for(ARCH, os.path.join(tmp, "b"), RESUME_STEPS, **kw)
            first.run(RESUME_STEPS // 2)
            resumed = trainer_for(ARCH, os.path.join(tmp, "b"), RESUME_STEPS, **kw)
            if resumed.step != RESUME_STEPS // 2 or resumed.stream.step != RESUME_STEPS // 2:
                fail(f"trainer (b): resumed at step {resumed.step}, stream {resumed.stream.step}")
            resumed.run()
    finally:
        torch.use_deterministic_algorithms(False)
    launches, bwd = cops.launches, cops.bwd_launches
    if launches == 0 or bwd == 0:
        fail(f"trainer (b): chimera_attention launched forward {launches}, backward {bwd}")
    diff = param_diff(direct.params, resumed.params)
    odiff = param_diff(direct.opt_state, resumed.opt_state)
    if diff > RESUME_TOL or odiff > RESUME_TOL:
        fail(f"trainer (b): resumed run differs from the direct one: params {diff:.3e}, "
             f"optimizer {odiff:.3e} > {RESUME_TOL:g}")
    log("trainer", f"(b) resume under torch.use_deterministic_algorithms(True): {RESUME_STEPS} "
                   f"steps direct vs {RESUME_STEPS // 2} + {RESUME_STEPS // 2} through a "
                   f"checkpoint (the new Trainer reported step {RESUME_STEPS // 2}): final "
                   f"parameters max abs diff {diff:.3e}, optimizer state {odiff:.3e} (tolerance "
                   f"{RESUME_TOL:g}); chimera_attention launches {launches}, its backward's "
                   f"{bwd}")
    return {"launches": launches, "bwd": bwd, "diff": diff}


def _decision_sites():
    """(kind, module, name) of each place a Trainer run of the codebook map
    takes a discrete decision from its own inputs: the codes of
    ``assign_codes`` (called by the feature map and by the Trainer's tick)
    and the global tier's sign-LSH signature bits of ``make_signature``."""
    from repro_torch.core import feature_maps as F
    from repro_torch.core import key_selection as KS
    from repro_torch.train import trainer as T

    # the unwrapped functions, for decide() inside a recorder or a feeder
    _DECIDE.setdefault("codes", F.assign_codes)
    _DECIDE.setdefault("signatures", KS.make_signature)
    return (("codes", F, "assign_codes"), ("codes", T, "assign_codes"),
            ("signatures", KS, "make_signature"))


_DECIDE = {}


def decide(kind, a, b):
    """The decision of ``kind`` on its two inputs (centroids and rows; rows
    and the signature projection), and each output's margin: the codes'
    top-2 gap of ||c||^2 - 2 x.c (``assign_codes``' argmin), the
    signature bits' |x . proj| (``make_signature``'s sign)."""
    import torch
    from repro_torch.core import feature_maps as F

    _decision_sites()
    with torch.no_grad():
        if kind == "codes":
            s = torch.sum(a * a, dim=-1) - 2.0 * F._matmul(b, a.T)
            top = torch.topk(s, 2, dim=-1, largest=False).values
            return _DECIDE[kind](a, b), top[..., 1] - top[..., 0]
        return _DECIDE[kind](a, b), torch.abs(F._matmul(a, b))


# a decision that differs between the card and the CPU on the same inputs
# where the CPU's margin exceeds this is a fault: codes, the top-2 gap of
# the assignment scores (|scores| ~ 64 at d 64); signature bits, |x . proj|
# (~10 at d 64): both sides' fp32 sums of 64 products differ by ~1e-6
DECISION_MARGIN = {"codes": 1e-4, "signatures": 1e-4}


class DecisionRecorder:
    """Wraps each decision site (``_decision_sites``), keeping every call's
    inputs and outputs in ``calls[kind]`` (cloned on their device: an
    install swaps the centroids in place)."""

    def __enter__(self):
        self.calls = {"codes": [], "signatures": []}
        self.saved = [(mod, name, getattr(mod, name)) for _, mod, name in _decision_sites()]
        for (kind, mod, name), (_, _, real) in zip(_decision_sites(), self.saved):
            def record(a, b, kind=kind, real=real):
                out = real(a, b)
                self.calls[kind].append(tuple(t.detach().clone() for t in (a, b, out)))
                return out

            setattr(mod, name, record)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def count_flips(calls):
    """Recompute each recorded decision on the CPU from the same inputs;
    returns {kind: (outputs, flips, flips where the CPU's margin exceeds
    DECISION_MARGIN)}."""
    out = {}
    for kind, rec in calls.items():
        n = flips = sure = 0
        for a, b, got in rec:
            want, margin = decide(kind, a.cpu(), b.cpu())
            f = got.cpu() != want
            n, flips = n + f.numel(), flips + int(f.sum())
            sure += int((f & (margin > DECISION_MARGIN[kind])).sum())
        out[kind] = (n, flips, sure)
    return out


class DecisionFeeder:
    """Within the block, the i-th call of each kind of decision site
    returns the output of the i-th call of that kind that ``calls`` (a
    DecisionRecorder's) holds, on the call's device: the run takes the
    recorded run's discrete decisions as an input.  A call whose inputs
    differ in shape from the record's, or a call past the record's end,
    fails.  The run's own decisions are still computed: ``differ[kind]``
    counts the outputs where they differ from the fed ones and
    ``margin[kind]`` is the largest margin among them (information, not a
    limit)."""

    def __init__(self, calls):
        self.calls = calls
        self.done = dict.fromkeys(calls, 0)
        self.differ, self.n, self.margin = (dict.fromkeys(calls, 0), dict.fromkeys(calls, 0),
                                            dict.fromkeys(calls, 0.0))

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name)) for _, mod, name in _decision_sites()]
        for kind, mod, name in _decision_sites():
            def feed(a, b, kind=kind):
                i = self.done[kind]
                if i >= len(self.calls[kind]):
                    fail(f"trainer (c): the fed run makes {kind} call {i}, the record holds "
                         f"{len(self.calls[kind])}")
                a_rec, b_rec, out = self.calls[kind][i]
                if a.shape != a_rec.shape or b.shape != b_rec.shape:
                    fail(f"trainer (c): {kind} call {i} takes inputs {tuple(a.shape)} and "
                         f"{tuple(b.shape)}, the record's {tuple(a_rec.shape)} and "
                         f"{tuple(b_rec.shape)}")
                out = out.to(a.device)
                own, margin = decide(kind, a, b)
                differ = own != out
                self.done[kind], self.n[kind] = i + 1, self.n[kind] + differ.numel()
                if differ.any():
                    self.differ[kind] += int(differ.sum())
                    self.margin[kind] = max(self.margin[kind], float(margin[differ].max()))
                return out

            setattr(mod, name, feed)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)

    def own(self):
        """The fed run's own decisions against the fed ones, as a phrase."""
        return ", ".join(f"{kind} {self.differ[k]} of {self.n[k]} (largest margin "
                         f"{self.margin[k]:.3e})" for k, kind in (("codes", "codes"),
                                                                 ("signatures", "signature bits")))


def farthest_gaps(x, picks):
    """At each pick after the first of a farthest-point walk over ``x``
    (CPU), the relative gap between the largest squared distance to the
    picks before it and the next smaller value (duplicated rows share a
    value and take the first index on either device)."""
    import torch

    d2 = torch.sum((x - x[picks[0]]) ** 2, dim=-1)
    gaps = [float("inf")]
    for p in picks[1:]:
        top = d2.max()
        below = d2[d2 < top]
        gaps.append(float((top - below.max()) / top) if below.numel() else float("inf"))
        d2 = torch.minimum(d2, torch.sum((x - x[p]) ** 2, dim=-1))
    return gaps


class KmeansProbe:
    """Within the block, each k-means of the two-timescale controller
    records, under the recluster's step (``step``, set by the caller before
    each recluster), its farthest-point picks and centroids in ``rec``.
    Given ``card`` (the card run's record, on the same reservoirs), the run
    takes the card's picks as an input instead, and holds them first: its
    own walk on the same samples may differ from the card's only at a near
    tie, its first differing pick's top-2 gap at most KMEANS_TIE_RTOL
    (relative), else the run fails; its centroids, Lloyd's steps from the
    card's picks, are held to the card's within KMEANS_ATOL.  ``rec`` then
    holds, per recluster, the picks differing, the first one's gap and the
    centroid error."""

    def __init__(self, rec, card=None):
        self.rec, self.card, self.step = rec, card, None

    def __enter__(self):
        import torch
        from repro_torch.core import two_timescale as TT

        self.saved = real_walk, real_kmeans = TT.farthest_points, TT.kmeans

        def walk(x, k, key):
            own = real_walk(x, k, key)
            if self.card is None:
                self.rec[self.step] = {"picks": own.cpu().tolist()}
                return own
            what = f"trainer (c) recluster at step {self.step}"
            card = self.card[self.step]["picks"]
            own = own.cpu().tolist()
            if len(own) != len(card):
                fail(f"{what}: {len(own)} farthest-point picks, the card made {len(card)}")
            first = next((i for i, (a, b) in enumerate(zip(own, card)) if a != b), None)
            gap = None if first is None else farthest_gaps(x.cpu(), own)[first]
            if gap is not None and gap > KMEANS_TIE_RTOL:
                fail(f"{what}: farthest-point pick {first} is row {card[first]} on the card and "
                     f"{own[first]} on the CPU, whose top two distances differ by {gap:.3e} "
                     f"(relative) > {KMEANS_TIE_RTOL:g}")
            self.rec[self.step] = {"differ": sum(a != b for a, b in zip(own, card)),
                                   "first": first, "gap": gap}
            return torch.tensor(card, dtype=torch.long, device=x.device)

        def kmeans(*a, **kw):
            out = real_kmeans(*a, **kw)
            cent = out[0].detach().cpu()
            if self.card is None:
                self.rec[self.step]["centroids"] = cent
            else:
                self.rec[self.step]["err"] = compare(
                    f"trainer (c) recluster at step {self.step}: k-means centroids from the "
                    "card's picks, CPU vs card", cent, self.card[self.step]["centroids"],
                    atol=KMEANS_ATOL, rtol=0.0)
            return out

        TT.farthest_points, TT.kmeans = walk, kmeans
        return self

    def __exit__(self, *exc):
        from repro_torch.core import two_timescale as TT

        TT.farthest_points, TT.kmeans = self.saved


def trainer_codebook(cops):
    """(c) the codebook map with the two-timescale controller, timed against
    the same run without it (the controller's reclusters, k-means on the
    card, timed apart); then the controller run again on the card, in
    deterministic mode (the embedding's backward otherwise adds with atomics
    in any order) with every discrete decision (the codebook's codes, the
    global tier's signature bits), every reservoir and every k-means
    recorded, held to the CPU by two checks that do not depend on the
    host's arithmetic.  (1) The decisions on the same inputs: every
    recorded code and signature bit recomputed on the CPU from the card's
    inputs (a flip where the CPU's margin exceeds DECISION_MARGIN fails),
    and every recluster's farthest-point picks and centroids against the
    CPU's on the card's reservoir (KmeansProbe).  (2) The losses, install
    history, delta_map and installed centroids given those decisions: a CPU
    run from the same seed that clusters the card's reservoirs and takes,
    at every decision and every recluster, the card's codes, signature bits
    and picks as inputs (DecisionFeeder, KmeansProbe), within
    REF_LOSS_RTOL.  Its inputs differ from the card's by roundings, so a
    decision of its own flips at a near tie and moves the loss (up to
    1.353e-4 on some hosts with no decision fed, ~1e-5 on others; two CPU
    runs fed only the codes, 8.6e-5 apart): feeding every decision, not
    one copied at chosen ties, leaves that out, and (1) holds the
    decisions on their own.  How many of its own decisions differ from the
    fed ones is logged."""
    import tempfile

    import torch

    from repro_torch.core.two_timescale import TwoTimescaleConfig

    arch = codebook_arch()
    tt = TwoTimescaleConfig(t_cp_steps=CODEBOOK_T_CP)
    runs, recluster_s, where = {}, [], set()
    for label, cfg in (("controller", tt), ("no controller", None)):
        with tempfile.TemporaryDirectory(prefix="chimera-codebook-") as tmp:
            tr = trainer_for(arch, tmp, CODEBOOK_STEPS, two_timescale=cfg)
            if cfg is not None:  # seconds of each recluster (k-means on the card, delta_map)
                real = tr.controller.maybe_recluster

                def recluster(*a, real=real, **k):
                    t0 = time.perf_counter()
                    out = real(*a, **k)
                    if out[1] is not None:
                        recluster_s.append(time.perf_counter() - t0)
                        where.add(out[0].device.type)
                    return out

                tr.controller.maybe_recluster = recluster
            cops.launches = cops.bwd_launches = 0
            out, loop_s, _ = timed_run(tr, CODEBOOK_STEPS)
            if cops.launches == 0 or cops.bwd_launches == 0:
                fail(f"trainer (c) {label}: chimera_attention launched forward {cops.launches}, "
                     f"backward {cops.bwd_launches}")
            runs[label] = (tr, loop_s / CODEBOOK_STEPS * 1e3, cops.launches, cops.bwd_launches,
                           logged_losses(f"trainer (c) {label}", out))
    tr, ms, launches, bwd, losses = runs["controller"]
    hist = tr.controller.history
    if not any(r.installed for r in hist) or not all(r.churn_ok for r in hist):
        fail(f"trainer (c): install records {hist}")
    cent = tr.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["centroids"]
    if not all(bool((cent[i] == cent[0]).all()) for i in range(cent.shape[0])):
        fail("trainer (c): the installed centroids differ across the layer axis")
    if where != {"cuda"}:
        fail(f"trainer (c): the reclusters' centroids lie on {sorted(where)}, not the card")
    ms_plain, bwd = runs["no controller"][1], bwd + runs["no controller"][3]
    log("trainer", f"(c) codebook map (m 256, 256 centroids), {CODEBOOK_STEPS} steps, T_cp "
                   f"{CODEBOOK_T_CP} steps: {ms:.2f} ms/step with the controller, "
                   f"{ms_plain:.2f} without; the reclusters (k-means on the card, delta_map) "
                   + ", ".join(f"{t:.3f}" for t in recluster_s)
                   + f" s, {sum(recluster_s) / CODEBOOK_STEPS * 1e3:.2f} ms/step of the "
                   f"{ms - ms_plain:.2f} ms/step difference; installs "
                   + ", ".join(f"step {r.step} delta_map {r.delta_map:.4f} installed "
                               f"{r.installed} churn_ok {r.churn_ok}" for r in hist)
                   + f"; loss first {losses[0]:.5f} last {losses[-1]:.5f}; chimera_attention "
                   f"launches {launches} with the controller, backward {bwd} in both runs")

    got, t_dev, shared, walks = {}, {}, {}, {"cuda": {}, "cpu": {}}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory(prefix="chimera-codebook-") as tmp:
            t0 = time.perf_counter()
            tr = trainer_for(arch, tmp, CODEBOOK_STEPS, device=dev, two_timescale=tt)
            real = tr.controller.maybe_recluster
            probe = KmeansProbe(walks[dev], card=walks["cuda"] if dev == "cpu" else None)

            def recluster(step, *a, real=real, ctl=tr.controller, dev=dev, probe=probe, **k):
                # the card's reservoir at each epoch, clustered by both runs
                if dev == "cuda":
                    shared[step] = list(ctl._reservoir)
                elif step in shared:
                    ctl._reservoir = list(shared[step])
                probe.step = step
                return real(step, *a, **k)

            tr.controller.maybe_recluster = recluster
            if dev == "cuda":
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    with DecisionRecorder() as rec, probe:
                        out = tr.run()
                finally:
                    torch.use_deterministic_algorithms(False)
            else:
                with DecisionFeeder(rec.calls) as fed, probe:
                    out = tr.run()
                made = {k: len(v) for k, v in rec.calls.items()}
                if fed.done != made:
                    fail(f"trainer (c): the fed run made {fed.done} decision calls, the card's "
                         f"{made}")
            t_dev[dev] = time.perf_counter() - t0
        got[dev] = (logged_losses(f"trainer (c) {dev}", out), tr.controller.history,
                    tr.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["centroids"])
    (lc, hc, cc), (lp, hp, cp) = got["cuda"], got["cpu"]
    t0 = time.perf_counter()
    flips = count_flips(rec.calls)
    flips_s = time.perf_counter() - t0
    for kind, (n, f, sure) in flips.items():
        if sure:
            fail(f"trainer (c): {sure} of {n} {kind} differ between the card and the CPU on the "
                 f"same inputs where the CPU's margin exceeds {DECISION_MARGIN[kind]:g}")
    epochs = sorted(walks["cpu"].items())
    if [step for step, _ in epochs] != sorted(walks["cuda"]):
        fail(f"trainer (c): reclusters at steps {sorted(walks['cuda'])} on the card and "
             f"{[step for step, _ in epochs]} on the CPU")
    log("trainer", "(c) (1) the discrete decisions on the same inputs, recomputed on the CPU "
                   f"from the card's ({flips_s:.1f} s): " + "; ".join(
                       f"{kind}: {len(rec.calls[kind])} calls, {n} outputs, {f} differ, {sure} "
                       f"with a margin above {DECISION_MARGIN[kind]:g}"
                       for kind, (n, f, sure) in flips.items()) + "; "
                   + "; ".join(f"recluster at step {step}: farthest-point picks of the CPU's own "
                               f"walk on the card's reservoir differing {e['differ']} (first "
                               f"{e['first']}, top-2 gap {e['gap']}, tolerance "
                               f"{KMEANS_TIE_RTOL:g}), centroids from the card's picks within "
                               f"{e['err']:.3e} (tolerance {KMEANS_ATOL:g})"
                               for step, e in epochs))
    gaps = [abs(a - b) / abs(b) for a, b in zip(lc, lp)]
    lerr = max(gaps)
    if lerr > REF_LOSS_RTOL:
        at = next(i for i, g in enumerate(gaps) if g > REF_LOSS_RTOL)
        fail(f"trainer (c): card and CPU losses differ by {lerr:.3e} > {REF_LOSS_RTOL:g}, first "
             f"at logged step {at}, with the card's decisions and picks fed to the CPU run (its "
             f"own differ from them at: {fed.own()})")
    key = [(r.step, r.installed, r.churn_ok) for r in hc]
    if key != [(r.step, r.installed, r.churn_ok) for r in hp]:
        fail(f"trainer (c): card install history {hc} differs from the CPU's {hp}")
    dm = max(abs(a.delta_map - b.delta_map) / abs(b.delta_map) for a, b in zip(hc, hp))
    if dm > CODEBOOK_DM_RTOL:
        fail(f"trainer (c): delta_map card vs CPU differs by {dm:.3e} (relative) > "
             f"{CODEBOOK_DM_RTOL:g}: {[r.delta_map for r in hc]} vs {[r.delta_map for r in hp]}")
    cerr = compare("trainer (c) installed centroids card vs CPU", cc, cp, atol=ATTN_ATOL)
    log("trainer", f"(c) (2) the card run ({t_dev['cuda']:.1f} s, deterministic and recorded) "
                   f"against the CPU run fed the card's decisions and picks ({t_dev['cpu']:.1f} "
                   f"s, {fed.done} calls in the card's order and shapes): losses within "
                   f"{lerr:.3e} (tolerance {REF_LOSS_RTOL:g}; by logged step "
                   + " ".join(f"{g:.1e}" for g in gaps) + f"); installs {key} equal; delta_map "
                   f"within {dm:.3e} (relative, tolerance {CODEBOOK_DM_RTOL:g}); installed "
                   f"centroids within {cerr:.3e} (tolerance {ATTN_ATOL:g} + {RTOL:g}*|ref|); the "
                   f"CPU run's own decisions differ from the fed ones at: {fed.own()}")
    return {"launches": launches + runs["no controller"][2], "bwd": bwd, "ms": ms,
            "ms_plain": ms_plain, "installs": sum(r.installed for r in hist),
            "loss_gap": lerr, "own_differ": fed.differ}


def codebook_program():
    """The paper's classifier with an 8-bit codebook table compiled by the
    port from the exp_prf map (compile_codebook), compiled into a program,
    saved, loaded on the card and on the CPU and deployed on each."""
    import shutil
    import tempfile

    import torch
    from repro_torch.compile import DataplaneProgram, compile_program
    from repro_torch.core.feature_maps import FeatureMapConfig, compile_codebook, init_feature_map
    from repro_torch.core.two_timescale import prng_key
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.flow_ingest import fused as fmod
    from repro_torch.serve.deploy import DeploySpec
    from repro_torch.serve.flow_engine import FlowEngineConfig
    from repro_torch.train import classifier as C

    arch = codebook_arch(bits=8)
    fm_cfg = arch.chimera.feature_map
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256, sig_words=8)
    params = C.init_classifier(ccfg, torch.Generator().manual_seed(SEED), device="cuda")
    g = torch.Generator().manual_seed(SEED + 11)
    base = FeatureMapConfig(kind="exp_prf", m=fm_cfg.m)
    samples = torch.randn((4096, arch.head_dim), generator=g).to("cuda")
    cb = compile_codebook(fm_cfg, base, init_feature_map(base, arch.head_dim, g, "cuda"), samples,
                          prng_key(SEED))
    fm = params["backbone"]["blocks"]["b0"]["attn"]["chimera"]["fm"]
    n = fm["centroids"].shape[0]
    for name, t in cb.items():  # one table for every layer
        fm[name] = t[None].expand((n,) + tuple(t.shape)).contiguous()
    program = compile_program(ccfg, params, rules=lambda c: program_rules(c, "cuda"),
                              waivers=("state-quantization",), verify=False)
    places = {"card": "cuda", "cpu": "cpu"}
    tmp = tempfile.mkdtemp(prefix="chimera-codebook-program-")
    try:
        program.save(tmp)
        loaded = {where: DataplaneProgram.load(tmp, device=dev) for where, dev in places.items()}
    finally:
        shutil.rmtree(tmp)
    table = loaded["card"].params["backbone"]["blocks"]["b0"]["attn"]["chimera"]["fm"]["table"]
    if table.dtype != torch.int8:
        fail(f"codebook program: the loaded table is {table.dtype}")
    compare("codebook program table", table, fm["table"])
    fcfg = FlowEngineConfig(capacity=512, lanes=64, state_budget_bytes=1 << 34)
    eng = {where: loaded[where].deploy(DeploySpec(flow=fcfg, device=dev))
           for where, dev in places.items()}
    sc = FlowScenario(kind="protocol-mix", pkt_len=PKT_LEN, packets_per_batch=CODEBOOK_PACKETS,
                      seed=SEED + 12)
    margins = RoundMargins(eng["card"])
    counted = ("decode_step", "flow_score")
    worst = {k: 0.0 for k in FLOATS}
    launched = {name: 0 for name in counted}
    for _ in range(CODEBOOK_BATCHES):
        b = sc.next_batch()
        for name in counted:
            fmod.COUNTED[name].launches = 0
        with margins:
            got = eng["card"].ingest(b["flow_ids"], b["tokens"])
        for name in counted:
            launched[name] += fmod.COUNTED[name].launches
        want = eng["cpu"].ingest(b["flow_ids"], b["tokens"])
        errs = hold_outputs("codebook program card vs CPU", got, want, REFERENCE_TOL[64],
                            margins.margins())
        worst = {k: max(worst[k], errs[k]) for k in FLOATS}
    if not all(launched.values()):
        fail(f"codebook program: a kernel never launched on the card's engine: {launched}")
    if eng["card"].stats != eng["cpu"].stats or eng["card"].table.slot_of != \
            eng["cpu"].table.slot_of:
        fail("codebook program: the card's engine stats or slots differ from the CPU's")
    map_rows = [e for e in program.ledger.entries if e.stage == "resource-ledger"]
    log("trainer", f"(c) codebook program (8-bit table from compile_codebook, 256 centroids): "
                   f"compiled, saved, loaded on the card and the CPU, deployed (capacity "
                   f"{fcfg.capacity}, lanes {fcfg.lanes}); {CODEBOOK_BATCHES} protocol-mix "
                   f"batches of {CODEBOOK_PACKETS} packets: decisions identical (pred wherever "
                   f"the top-2 margin exceeds {REF_PRED_MARGIN:g}), max diffs "
                   + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                   + f" (tolerance {REFERENCE_TOL[64]:g}); launches on the card {launched}; "
                   f"ledger {[(e.resource, e.used, e.budget) for e in map_rows]}")
    return launched


def trainer_lm100m(cops):
    """(d) lm_100m through the Trainer: 1 warm-up step, then LM100M_STEPS
    timed; then one step of the same step function under the profiler."""
    import tempfile

    import torch
    from repro_torch.optim.optimizer import tree_flatten
    from repro_torch.train import classifier as C
    from repro_torch.train import make_train_step

    cfg = lm_100m()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    with tempfile.TemporaryDirectory(prefix="chimera-lm100m-") as tmp:
        tr = trainer_for(cfg, tmp, LM100M_STEPS + 1, warmup=5)
        n_params = sum(t.numel() for t in tree_flatten(tr.params)[0])
        timed_run(tr, 1)
        torch.cuda.reset_peak_memory_stats()
        cops.launches = cops.bwd_launches = 0
        out, loop_s, save_s = timed_run(tr, LM100M_STEPS + 1)
        launches, bwd = cops.launches, cops.bwd_launches
        peak = torch.cuda.max_memory_allocated()
    if launches == 0 or bwd == 0:
        fail(f"trainer (d): chimera_attention launched forward {launches}, backward {bwd}")
    losses = logged_losses("trainer (d)", out)
    ms = loop_s / LM100M_STEPS * 1e3
    log("trainer", f"(d) {cfg.name} ({n_params} parameters; 12 layers, d 768, d_head 64, d_ff "
                   f"2048, vocab 32000, exp_prf m 64, L 128, n_global 32, fp32), batch 8 x 128: "
                   f"{ms:.2f} ms/step over {LM100M_STEPS} steps after 1 warm-up, "
                   f"{8 * 128 / (ms / 1e3):.0f} tokens/s; loss step {out['log'][0]['step']} "
                   f"{losses[0]:.5f}, step {out['log'][-1]['step']} {losses[-1]:.5f}; "
                   f"chimera_attention launches {launches} "
                   f"({launches / LM100M_STEPS:.1f} per step), its backward's {bwd}; final save "
                   f"{save_s:.3f} s; "
                   f"max_memory_allocated {peak}, {peak - base} above the {base} B allocated "
                   f"before the part")
    step = make_train_step(cfg, tr.opt_cfg)
    b = C.batch_to_device(tr.stream.next_batch(), "cuda")
    step(tr.params, tr.opt_state, b)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(tr.params, tr.opt_state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, wall, f"one {cfg.name} step (forward, backward, AdamW)")
    return {"launches": launches, "bwd": bwd, "ms": ms, "peak": peak - base}


def phase_trainer(recs):
    """The Trainer on the card.  chimera_attention at (d)'s shape against
    its plain version (timed, with the Function's gradients); then (a)
    launch/train.py at its defaults on the paper's model, the launcher's
    smoke config card against CPU; (b) a resumed run against a direct one;
    (c) the codebook map with the two-timescale controller, and a codebook
    program deployed on the card and the CPU; (d) lm_100m.  The
    chimera_attention counters (forward and backward) are zeroed before each
    part's run and read after it."""
    from repro_torch.kernels.chimera_attention import ops as cops

    rec = check_chimera(True, shape=(8, 12, 1, 128, 64, 128), seed=SEED + 13)
    recs["chimera_attention"].setdefault("other_shapes", []).append(
        {k: rec[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
    check_chimera_grads(B=8, Hkv=12, Gq=1, T=128, m=64, L=128)
    parts = {"a": trainer_launcher(cops)}
    trainer_card_vs_cpu()
    parts["b"] = trainer_resume(cops)
    parts["c"] = trainer_codebook(cops)
    program = codebook_program()
    parts["d"] = trainer_lm100m(cops)
    launches = {"chimera_attention": sum(p["launches"] for p in parts.values()),
                "chimera_attention_bwd": sum(p["bwd"] for p in parts.values()), **program}
    log("trainer", f"launches on the trainer phase's paths: chimera_attention "
                   + ", ".join(f"({k}) {p['launches']}" for k, p in parts.items())
                   + ", its backward " + ", ".join(f"({k}) {p['bwd']}" for k, p in parts.items())
                   + f"; the codebook program's engine {program}")
    return {"launches": launches}


# --------------------------------------------------------------------------

def main():
    # one fixed cuBLAS workspace (8 x 4 MiB) for every phase, so that the
    # trainer phase's resume check may run cuBLAS in deterministic mode:
    # PyTorch reads this once, at its first cuBLAS call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    # segments that grow and shrink in place: the training phases' steps peak
    # at 69 GiB of the card's 79, and with fixed segments the free space left
    # split between them once held no 3.5 GiB block for Mixtral's Chimera
    # step's AdamW update (out of memory at 65.4 GiB allocated, 9.6 GiB
    # reserved but unallocated)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    t_start = time.perf_counter()
    phases = {}  # seconds of every phase, in the order run

    def timed(name, fn, *args):
        log("time", f"{name}: start at {time.perf_counter() - t_start:.1f} s")
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = round(time.perf_counter() - t0, 3)
        log("time", f"{name}: {phases[name]:.1f} s")
        return out

    card = timed("device", phase_device)
    import torch

    timed("build", phase_build)
    recs = timed("kernels", phase_kernels)
    launches = timed("engine", phase_engine, recs)["launches"]
    program = timed("program", phase_program)
    recs["int_flow_score"] = program["int_flow_score"]
    launches["int_flow_score"] = 0
    for name, n in program["launches"].items():
        launches[name] += n
    for name, n in timed("verify", phase_verify)["launches"].items():
        launches[name] += n
    for name, n in timed("adapt", phase_adapt)["launches"].items():
        launches[name] += n
    for name, n in timed("shard", phase_shard)["launches"].items():
        launches[name] += n
    train = timed("train", phase_train, recs)["launches"]
    for name in ("chimera_attention", "chimera_attention_bwd"):
        launches[name] = train[name]
    launches["window_attention"] = timed("serve", phase_serve, recs)["launches"]["window_attention"]
    for name, n in timed("lm-chimera", phase_lm_chimera, recs)["launches"].items():
        launches[name] += n
    for name, n in timed("lm-mla", phase_lm_mla, recs)["launches"].items():
        launches[name] += n
    for name, n in timed("train-softmax", phase_train_softmax, recs)["launches"].items():
        launches[name] = launches.get(name, 0) + n
    for name, n in timed("train-chimera", phase_train_chimera, recs)["launches"].items():
        launches[name] += n
    for name, n in timed("train-encdec", phase_train_encdec, recs)["launches"].items():
        launches[name] += n
    for name, n in timed("train-ssm", phase_train_ssm, recs)["launches"].items():
        launches[name] += n
    for name, n in timed("lm-ssm", phase_lm_ssm, recs)["launches"].items():
        launches[name] += n
    for name, n in timed("lm-encdec", phase_lm_encdec, recs)["launches"].items():
        launches[name] += n
    for name, n in timed("trainer", phase_trainer, recs)["launches"].items():
        launches[name] += n
    timed("reference n_global=0", phase_reference, 0)
    timed("reference n_global=64", phase_reference, 64)
    timed("reference train", phase_reference_train)
    timed("reference serve", phase_reference_serve)
    timed("smoke configs", phase_smoke_configs)
    total = time.perf_counter() - t_start
    phases["outside the phases"] = round(total - sum(phases.values()), 3)
    phases["total"] = round(total, 3)
    print(f"[done] {total:.1f} s on {card}", flush=True)
    print(json.dumps({"kernels": kernel_lines(recs, launches)}), flush=True)
    print(json.dumps({"phases": phases}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def kernel_lines(recs, launches):
    info = {
        "decode_step": ("src/repro_torch/csrc/decode_step.cu",
                        "src/repro/kernels/decode_step/kernel.py:93"),
        "flow_score": ("src/repro_torch/csrc/flow_score.cu",
                       "src/repro/kernels/flow_ingest/kernel.py:53"),
        "int_flow_score": ("src/repro_torch/csrc/int_flow_score.cu",
                           "src/repro/compile/int_lowering.py:367 (jnp, no pallas_call)"),
        "chimera_attention": ("src/repro_torch/csrc/chimera_attention.cu",
                              "src/repro/kernels/chimera_attention/kernel.py:104"),
        "window_attention": ("src/repro_torch/csrc/window_attention.cu",
                             "src/repro/kernels/window_attention/kernel.py:89"),
        "window_attention_bwd": ("src/repro_torch/csrc/window_attention_bwd.cu",
                                 "src/repro/kernels/window_attention/ops.py:37 (the custom_vjp "
                                 "backward, jnp autodiff of ref.py)"),
        "chimera_attention_bwd": ("src/repro_torch/csrc/chimera_attention_bwd.cu",
                                  "src/repro/kernels/chimera_attention/ops.py:52 (the "
                                  "custom_vjp backward, jax.vjp of ref.py)"),
    }
    lines = []
    for name, (source, replaces) in info.items():
        r = recs[name]
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
        })
        for key in ("library_of", "fwd_ms", "fwd_bound_ms", "fwd_bwd_ms", "library_fwd_bwd_ms",
                    "max_abs_err_of", "fp32_cores_ms", "split", "other_shapes"):
            if key in r:
                lines[-1][key] = r[key]
    return lines


if __name__ == "__main__":
    main()
