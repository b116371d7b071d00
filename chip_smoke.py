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
               chimera_attention Function.
4. engine    — the serving path: a ``FlowEngine`` at the paper's full width
               (chimera-dataplane: 4 layers, d 256, m 256, L 64, n_global
               64; capacity 4096, lanes 256) with random weights from a
               seed ingests protocol-mix and rule-violating batches.
5. train     — the training path at the same width: the classifier
               objective (``train_classifier``, batch 256 x 256 tokens) and
               the LM objective (``make_train_step``, batch 8 x 128), then
               one profiled classifier step (forward against backward) and
               one profiled LM step.
6. serve     — the LM serving path: ``ServeEngine`` on Mixtral-8x7B's
               softmax variant (sliding-window attention, MoE) at full width,
               2 of its 32 layers, random weights from a seed: a prefill of
               4 x 8192 tokens through the window_attention kernel, then 16
               new tokens per slot over the ring KV cache; one profiled
               prefill.
7. reference — the engine on a small table, 3 classifier training steps of
               a small model, and serving of a small softmax-SWA MoE model,
               on the card and on the CPU (plain versions): they must agree.
8. program   — run right after the engine phase: the int_flow_score kernel
               against its plain version bit for bit at the engine's shapes
               (and flow_score at 24 signature words), then the compiled
               DataplaneProgram: the paper's classifier compiled, saved,
               loaded and deployed per-round and fused, with two table
               swaps between batches, fused held to per-round after each;
               then int-emulation engines at the smoke width on the card
               beside the CPU, with a swap mid-stream.

9. adapt     — run after the program phase: (a) the port's launcher
               (``repro_torch.launch.flow_serve``'s build and serve) at the
               paper's width, fused, on the default drift schedule with no
               loop, under the sync and the async adaptation loop and with
               no loop again: packets/s, drift-path ms per tick, epoch ms,
               install µs, triggers, veto rate by phase; S pinned, no flip,
               no eviction, no capture after warm-up.  (b) The CPU tests'
               canonical drift replay at the tiny width, fused on the card
               against per-round on the CPU, float and int-emulation, and an
               async epoch held inside a fresh CUDA-graph capture.  (c) The
               red-team gate (smoke campaign + sample trace) on the card and
               on the CPU with the port's own weights.

Phases 4, 5, 6, 8 and 9 are the main paths: the kernels' launch counters are
zeroed just before each and read just after, and each fails if one of its
kernels never launched.  Then a JSON line with every kernel's numbers, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
without it.  It imports nothing of JAX and nothing of the JAX package.

``compare_builds({label: dir})`` times every kernel at its main path's
shape from this tree against the same kernels built from other trees'
``csrc`` directories, in turns on one card (this, other, other, this).
"""

from __future__ import annotations

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
                        else []) + re.findall(r"Li(\d+)E", targs)
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
                  "all": torch.full((B,), L - 1, dtype=torch.int32)}[fill].to("cuda"),
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
                 L=None):
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
    x = decode_inputs(B, ARCH.n_kv_heads, Gq, d, dv, m, L, with_global,
                      SEED + int(with_global), fill)
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
    n_fold = int(((x["count"] + 1) >= L).sum()) * ARCH.n_kv_heads
    rec = {"max_abs_err": err}
    log("kernels", f"decode_step BH={out_k.shape[0]} Gq={Gq} d={d} dv={dv} m={m} L={L} "
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


def check_score(M, timed, K=8, W=8):
    """The kernel against its plain version at the engine's 256 lanes with M
    rules; K classes and W signature words other than 8 take its generic
    path."""
    import torch
    from repro_torch.kernels.flow_ingest import ops

    params, rules, pooled, sig, sticky = score_inputs(LANES, M, SEED + M, K, W)
    out_k, st_k = ops.flow_score(params, rules, pooled, sig, sticky)
    out_p, st_p = ops.flow_score_plain(params, rules, pooled, sig, sticky)
    torch.cuda.synchronize()
    err = max(compare(f"flow_score {k}", out_k[k], out_p[k]) for k in out_p)
    compare("flow_score sticky", st_k, st_p)
    hard_hits = int(out_p["hard_hit"].sum())
    rec = {"max_abs_err": err}
    log("kernels", f"flow_score B={LANES} M={M} K={K} W={W} hard={hard_hits}: max abs err "
                   f"{err:.3e} (tolerance {ATOL:g} + {RTOL:g}*|ref|)")
    if timed:
        ms, call_ms = cuda_ms(lambda: ops.flow_score(params, rules, pooled, sig, sticky),
                              iters=200)
        plain_ms, plain_call_ms = cuda_ms(
            lambda: ops.flow_score_plain(params, rules, pooled, sig, sticky), iters=50)
        floor_ms = launch_floor_ms(LANES)
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


def chimera_inputs(B, Hkv, Gq, T, m, seed, requires_grad=False, d=None):
    """Normalized q, k, random v and their exp_prf features from the paper's
    feature map (public layout (B, Hkv, Gq, T, .)), on the card; d = dv is
    the paper's head width unless given."""
    import dataclasses

    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.core.feature_maps import _normalize, apply_feature_map, init_feature_map

    fm = dataclasses.replace(ARCH.chimera.feature_map, m=m)
    d = dv = d or ARCH.head_dim
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


def check_chimera(timed):
    """The kernel against its plain version at the train phase's shapes."""
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.kernels.chimera_attention import ops

    B, Hkv, Gq, T = TRAIN_BATCH, ARCH.n_kv_heads, ARCH.n_heads // ARCH.n_kv_heads, TRAIN_SEQ
    L, m, d = ARCH.chimera.chunk_size, ARCH.chimera.feature_map.m, ARCH.head_dim
    q, k, v, pq, pk = chimera_inputs(B, Hkv, Gq, T, m, SEED + 5)
    BH = B * Hkv
    flat = [q.reshape(BH, Gq, T, d), k.reshape(BH, T, d), v.reshape(BH, T, d),
            pq.reshape(BH, Gq, T, m), pk.reshape(BH, T, m)]
    with torch.no_grad():
        num_k, den_k = ops.chimera_attention_bh(*flat, chunk_size=L)
        num_p, den_p = ops.chimera_attention_partials_plain(q, k, v, pq, pk, L)
    torch.cuda.synchronize()
    err = max(compare("chimera_attention num", num_k, num_p.reshape(BH, Gq, T, d), atol=ATTN_ATOL),
              compare("chimera_attention den", den_k, den_p.reshape(BH, Gq, T), atol=ATTN_ATOL))
    rec = {"max_abs_err": err}
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


def check_chimera_edge(L, T, use_local, use_stream, m=64, d=None):
    """The kernel against its plain version at one edge shape of its
    contract (B 2 x Hkv 2, Gq 2, m 64 and the paper's d unless given);
    returns the max abs error."""
    import torch
    from repro_torch.kernels.chimera_attention import ops

    q, k, v, pq, pk = chimera_inputs(2, 2, 2, T, m, SEED + 8 + L + T + m, d=d)
    flat = [x.flatten(0, 1) for x in (q, k, v, pq, pk)]
    with torch.no_grad():
        a = ops.chimera_attention_bh(*flat, chunk_size=L, use_local=use_local,
                                     use_stream=use_stream)
        b = ops.chimera_attention_partials_plain(q, k, v, pq, pk, L, use_local, use_stream)
    return max(compare(f"chimera_attention {name} L={L} T={T} m={m} d={q.shape[-1]} Gq=2 "
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
            getattr(lib, name).restype = ctypes.c_int
    return lib


def compare_builds(others, rounds=1):
    """decode_step (the engine's shape, each fill pattern, with globals),
    flow_score (the engine's 256 lanes, one rule at 8 signature words and
    two at the compiled program's 24), chimera_attention (the
    train phase's shape) and window_attention (the serve phase's prefill)
    from this tree and from the trees of ``others`` (``{label: csrc
    directory}``), timed in turns on one card: each round runs this, the
    others, then the others and this again in reverse (this, other, other,
    this for one).  Prints each version's times and returns ``{kernel:
    {version: [ms, ...]}}``."""
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.configs.mixtral_8x7b import CONFIG as MIX
    from repro_torch.kernels import _build
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
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
    sargs = score_inputs(LANES, 1, SEED + 1)
    cases["flow_score M=1"] = (lambda: sops.flow_score(*sargs), 200)
    sargs24 = score_inputs(LANES, 2, SEED + 2, W=24)  # the compiled program's layout
    cases["flow_score M=2 W=24"] = (lambda: sops.flow_score(*sargs24), 200)
    wq, wk, wv = window_inputs(SERVE_SLOTS, MIX.n_heads, MIX.n_kv_heads, SERVE_T, MIX.head_dim,
                               MIX.head_dim, SEED + 20)
    cases["window_attention"] = (
        lambda: wops.sliding_window_attention(wq, wk, wv, MIX.sliding_window), 2)
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


def check_chimera_grads():
    """The autograd Function (kernel forward, plain backward) against
    autograd through the plain version, at a small shape with Gq 2."""
    import torch
    from repro_torch.kernels.chimera_attention import ops

    L, T, m = 64, 128, 64
    xs = chimera_inputs(2, 2, 2, T, m, SEED + 6, requires_grad=True)
    g = torch.Generator().manual_seed(SEED + 7)
    w_num = torch.randn(xs[0].shape[:-1] + (xs[2].shape[-1],), generator=g).to("cuda")
    w_den = torch.randn(xs[0].shape[:-1], generator=g).to("cuda")
    before = ops.launches
    outs = []
    for fn in (ops.chimera_attention_partials, ops.chimera_attention_partials_plain):
        num, den = fn(*xs, L)
        loss = (num * w_num).sum() + (den * w_den).sum()
        outs.append((num, den, torch.autograd.grad(loss, xs)))
    if ops.launches == before:
        fail("chimera_attention gradient check: the Function did not launch the kernel")
    err = max(compare("chimera_attention fwd num", outs[0][0], outs[1][0], atol=ATTN_ATOL),
              compare("chimera_attention fwd den", outs[0][1], outs[1][1], atol=ATTN_ATOL))
    gerr = max(compare(f"chimera_attention grad {n}", a, b, atol=ATTN_ATOL)
               for n, a, b in zip(("q", "k", "v", "phi_q", "phi_k"), outs[0][2], outs[1][2]))
    log("kernels", f"chimera_attention Function (B 2, Hkv 2, Gq 2, T {T}, m {m}): forward max "
                   f"abs err {err:.3e}, gradients of q, k, v, phi_q, phi_k max abs err {gerr:.3e} "
                   f"against autograd through the plain version")


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


def window_cost(B, H, Hkv, T, W, d, dv):
    """Bytes and flops of the windowed attention in fp32: each of q, k, v
    (per kv-head, as the kernel takes them) read once and o written once;
    QK^T and PV over the in-band pairs only (min(i + 1, W) keys for row i)."""
    n1 = min(T, W)
    pairs = n1 * (n1 + 1) // 2 + (T - n1) * W
    nbytes = 4 * (B * H * T * (d + dv) + B * Hkv * T * (d + dv))
    return nbytes, B * H * pairs * (2 * d + 2 * dv)


# (T, W, dtype, H, Hkv) of the edge shapes, each at d = dv = 64 and 128 and
# at the smoke configs' 16 and 32 (B 2): ragged T, W below a tile, W > T, a
# tile boundary (T 128, W 64), W a multiple of the tile with T not, and 1,
# 2 and 4 kv-heads
WINDOW_SMOKE_DIMS = (16, 32)
WINDOW_EDGES = (
    (200, 48, "float32", 4, 1), (200, 300, "float32", 4, 1), (77, 13, "float32", 2, 2),
    (200, 48, "bfloat16", 4, 1), (200, 48, "float32", 8, 4), (128, 64, "float32", 4, 2),
    (200, 128, "float32", 4, 2), (200, 128, "bfloat16", 8, 4),
)


def check_window_edge(T, W, dtype, H, Hkv, d, seed):
    """The kernel against its plain version at one edge shape (B 2, d = dv);
    fp32 within ATOL + RTOL * |ref|, bf16 within WIN_BF16_TOL of the plain
    version's fp32 result rounded to bf16.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.window_attention import ops

    dt = getattr(torch, dtype)
    xs = window_inputs(2, H, Hkv, T, d, d, seed, dt)
    with torch.no_grad():
        got = ops.sliding_window_attention(*xs, W)
        want = ops.sliding_window_attention_plain(*(x.float() for x in xs), W)
    name = f"window_attention T {T} W {W} d {d} {dt}"
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


def check_window(timed):
    """The kernel against its plain version at the serve phase's prefill shape
    (the plain version run over slices of WIN_PLAIN_HEADS query heads), and at
    ragged shapes; timed at the prefill shape."""
    import torch
    from repro_torch.configs.mixtral_8x7b import CONFIG as MIX
    from repro_torch.kernels.window_attention import ops

    B, H, Hkv, d, W, T = (SERVE_SLOTS, MIX.n_heads, MIX.n_kv_heads, MIX.head_dim,
                          MIX.sliding_window, SERVE_T)
    G = H // Hkv
    q, k, v = window_inputs(B, H, Hkv, T, d, d, SEED + 20)
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
    rec = {"max_abs_err": err}
    log("kernels", f"window_attention B {B} x H {H} (Hkv {Hkv}) T {T} W {W} d {d}: max abs err "
                   f"{err:.3e} (tolerance {ATOL:g} + {RTOL:g}*|ref|) against the plain version "
                   f"over {len(slices)} slices of {WIN_PLAIN_HEADS} heads")
    for i, edge in enumerate(WINDOW_EDGES):
        for dr in (64, 128) + WINDOW_SMOKE_DIMS:
            check_window_edge(*edge, dr, SEED + 21 + i)
    if timed:
        with torch.no_grad():
            ms, call_ms = cuda_ms(lambda: ops.sliding_window_attention(q, k, v, W), iters=2)
            plain_ms, _ = cuda_ms(lambda: [plain(b, h0) for b, h0 in slices], iters=1)
            # the yardstick: one PyTorch call on the same function, K and V
            # repeated to the query heads, the band as a boolean mask
            idx = torch.arange(T, device="cuda")
            band = ((idx[:, None] - idx[None, :]) >= 0) & ((idx[:, None] - idx[None, :]) < W)
            ke, ve = (x.repeat_interleave(G, dim=1) for x in (k, v))
            from torch.nn.attention import SDPBackend, sdpa_kernel

            def sdpa():  # the memory-efficient backend: the math one forms (BH, T, T)
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, ke, ve, attn_mask=band)

            lib_err = float((sdpa() - out).abs().max())
            library_ms, _ = cuda_ms(sdpa, iters=1)
        del ke, ve
        nbytes, flops = window_cost(B, H, Hkv, T, W, d, d)
        bound_ms, bound_by = bound(nbytes, TF32_PASSES * flops, TF32_FLOPS)
        fp32_ms = flops / FP32_FLOPS * 1e3
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, bytes=nbytes, flops=flops, call_ms=call_ms)
        log("kernels", f"window_attention device time at B {B} x H {H} (Hkv {Hkv}) T {T} W {W} "
                       f"d {d}: kernel {ms:.4f} ms (per call from Python {call_ms:.4f} ms), bound "
                       f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B; {flops} flop, "
                       f"x{TF32_PASSES} in TF32 on the tensor cores; on the fp32 CUDA cores "
                       f"they would take {fp32_ms:.4f} ms); "
                       f"scaled_dot_product_attention with a band mask {library_ms:.4f} ms "
                       f"(max abs diff to the kernel {lib_err:.3e}); plain version {plain_ms:.4f} "
                       f"ms over its {len(slices)} slices of {WIN_PLAIN_HEADS} heads (it forms "
                       f"(BH, T, T) fp32 scores)")
    del q, k, v, out
    torch.cuda.empty_cache()
    return rec


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
    return recs


# --------------------------------------------------------------------------
# 4. engine (the serving path)
# --------------------------------------------------------------------------

def paper_classifier(n_global=None):
    """The paper's classifier with random weights from SEED (optionally with
    another static-global set size)."""
    import dataclasses

    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.train import classifier as C

    arch = ARCH
    if n_global is not None:
        arch = dataclasses.replace(ARCH, chimera=dataclasses.replace(ARCH.chimera, n_global=n_global))
    ccfg = C.ClassifierConfig(arch=arch, n_classes=8, marker_base=256, sig_words=8)
    params = C.init_classifier(ccfg, torch.Generator().manual_seed(SEED))
    return ccfg, params


ENGINE_BATCHES = 3  # timed protocol-mix batches per engine


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

    ccfg, params = paper_classifier()
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
LM_BATCH, LM_SEQ, LM_STEPS = 8, 128, 5  # launch/train.py's --batch and --seq


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
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.chimera_attention import ops as cops
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.flow_ingest import ops as sops
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train import classifier as C
    from repro_torch.train.train_step import make_train_state, make_train_step

    ccfg, params = paper_classifier()
    s = packet_stream(SEED + 50)
    t0 = time.perf_counter()
    for _ in range(3):
        s.next_batch()
    data_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.reset_peak_memory_stats()

    # the main path: counters zeroed just before, read just after
    dops.launches = sops.launches = cops.launches = 0
    # (a) the classifier objective (benchmarks/common.py's loop)
    C.train_classifier(ccfg, packet_stream(SEED + 100), params, steps=TRAIN_WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, rules, losses = C.train_classifier(ccfg, packet_stream(SEED), params,
                                                steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cls_launches = cops.launches
    losses = check_losses("train classifier", losses)
    # held-out batches of the same traffic, far past the training steps
    ev = C.eval_classifier(ccfg, trained, rules, packet_stream(SEED, step=1000),
                           batches=EVAL_BATCHES)
    # (b) the LM objective (launch/train.py's defaults: batch 8, seq 128)
    lm_params, lm_opt = make_train_state(ARCH, torch.Generator().manual_seed(SEED), device="cuda")
    step = make_train_step(ARCH, AdamWConfig(lr=3e-4, total_steps=100))
    ts = TokenStream(vocab_size=ARCH.vocab_size, batch_size=LM_BATCH, seq_len=LM_SEQ + 1,
                     seed=SEED)
    lm_losses = []
    for i in range(LM_STEPS + 1):
        b = C.batch_to_device(ts.next_batch(), "cuda")
        if i == 1:  # step 0 is the warm-up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        lm_params, lm_opt, met = step(lm_params, lm_opt, b)
        lm_losses.append(met["loss"])
    torch.cuda.synchronize()
    lm_wall = time.perf_counter() - t1
    lm_losses = check_losses("train LM", torch.stack(lm_losses))
    launches = {"decode_step": dops.launches, "flow_score": sops.launches,
                "chimera_attention": cops.launches}
    if launches["chimera_attention"] == 0:
        fail(f"train: chimera_attention was never launched on the training path: {launches}")

    n_layers = ARCH.n_layers
    ms = wall / TRAIN_STEPS * 1e3
    log("train", f"classifier objective, paper width, batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens: "
                 f"{TRAIN_STEPS} steps in {wall:.3f} s after {TRAIN_WARMUP} warm-up steps: "
                 f"{ms:.2f} ms/step, {TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3):.0f} tokens/s "
                 f"(host data {data_ms:.2f} ms per batch, inside the loop)")
    log("train", f"classifier loss first {losses[0]:.5f} last {losses[-1]:.5f}; held-out "
                 f"macro-F1 {ev['f1']:.4f} (precision {ev['pr']:.4f}, recall {ev['rc']:.4f}, "
                 f"{EVAL_BATCHES} batches)")
    log("train", f"LM objective (make_train_step), batch {LM_BATCH} x {LM_SEQ}: "
                 f"{lm_wall / LM_STEPS * 1e3:.2f} ms/step over {LM_STEPS} steps after 1 warm-up, "
                 f"{LM_BATCH * LM_SEQ * LM_STEPS / lm_wall:.0f} tokens/s; loss first "
                 f"{lm_losses[0]:.5f} last {lm_losses[-1]:.5f}")
    per_step = cls_launches / (TRAIN_WARMUP + TRAIN_STEPS)
    log("train", f"launches in the training run: {launches}; chimera_attention {per_step:.1f} "
                 f"per classifier step ({n_layers} layers), so "
                 f"{per_step * recs['chimera_attention']['ms']:.3f} ms of kernel device time per "
                 f"step (phase 3's ms per launch)")
    log("train", f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
    profile_train_step(ccfg, trained, rules)
    b = C.batch_to_device(ts.next_batch(), "cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        step(lm_params, lm_opt, b)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    report_profile(prof, prof_wall, "one LM step (forward, backward, AdamW)")
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
# 7. reference: the card against the plain versions on the CPU
# --------------------------------------------------------------------------

# card vs CPU, fp32 on both sides with other summation orders, through 4
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
    """The engine on a small table (capacity 24, lanes 16, idle_timeout 2),
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

    ccfg, params = paper_classifier(n_global)
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
    forward (the window_attention kernel is forward only).  The Chimera
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
    launched = {name: fmod.COUNTED[name].launches - before[name] for name in kernels}
    if min(launched.values()) <= 0:
        fail(f"smoke: a kernel did not launch at the smoke widths: {launched}")
    log("smoke", f"kernel launches at the smoke widths: {launched}")


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
    bit, at the engine's 256 lanes with the plan of ``params``."""
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
    W = sig.shape[1]
    log("program", f"int_flow_score B={B} d={d} K={tables['cls_w'].shape[1]} W={W} M={M}: "
                   f"bit-identical to the plain version ({int(out_p['hard_hit'].sum())} vetoed "
                   f"lanes, trust_q in [{int(out_p['trust_q'].min())}, "
                   f"{int(out_p['trust_q'].max())}], plan f_h {plan.feature_frac}, shifts "
                   f"{plan.nn_shift}/{plan.sym_shift}/{plan.fusion_frac}, lut_shift "
                   f"{plan.lut_shift})")
    rec = {"max_abs_err": 0.0}
    if timed:
        ms, call_ms = cuda_ms(
            lambda: int_ops.int_flow_score(plan, tables, rules, hs, count, sig, sticky), iters=200)
        plain_ms, plain_call_ms = cuda_ms(
            lambda: il.int_flow_score(plan, tables, rules, hs, count, sig, sticky), iters=50)
        floor_ms = launch_floor_ms(B)
        nbytes, ops = int_score_cost(plan, tables, rules, hs, sig)
        bound_ms, bound_by = bound(nbytes, ops, INT32_OPS)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   floor_ms=floor_ms, bytes=nbytes, ops=ops, call_ms=call_ms,
                   plain_call_ms=plain_call_ms, library_ms=None)
        log("program", f"int_flow_score device time: kernel {ms:.5f} ms, launch floor (an empty "
                       f"kernel on the same grid) {floor_ms:.5f} ms, plain {plain_ms:.4f} ms, "
                       f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes} B, {ops} int32 ops); "
                       f"per call from Python: kernel {call_ms:.4f} ms, plain "
                       f"{plain_call_ms:.4f} ms")
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
    ccfg, params = paper_classifier()
    ccfg24 = dataclasses.replace(ccfg, sig_words=24)  # the layout the compile gives
    recs["int_flow_score"] = check_int_score(1, True, params, ccfg24)
    check_int_score(300, False, params, ccfg24)
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
    return recs


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
    """(a) The launcher's build-and-serve code at the paper's width on the
    default drift schedule's batches: with no loop (the staging ring),
    under the sync loop and under the async loop, each twice, in turns
    (no, sync, async, async, sync, no) so that an effect of the order on
    the timing cancels in the pairs."""
    import torch
    from repro_torch.data.pipeline import DriftScenario, parse_phases
    from repro_torch.launch import flow_serve as F

    ccfg, params = paper_classifier()
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
        dep = F.build(args, params=params)
        build_s = time.perf_counter() - t0
        if dep.program.ccfg.arch != ccfg.arch:
            fail("adapt: the launcher's arch is not the paper classifier's")
        eng = dep.engine
        warmed = set(eng.fused_graphs())
        res = F.serve(dep, keep=True)
        if set(eng.fused_graphs()) != warmed:
            fail(f"adapt {mode}: a CUDA graph was captured after warm-up: "
                 f"{sorted(set(eng.fused_graphs()) - warmed)}")
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

def main():
    t_start = time.perf_counter()
    card = phase_device()
    import torch

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log("time", f"{name}: {time.perf_counter() - t0:.1f} s")
        return out

    timed("build", phase_build)
    recs = timed("kernels", phase_kernels)
    launches = timed("engine", phase_engine, recs)["launches"]
    program = timed("program", phase_program)
    recs["int_flow_score"] = program["int_flow_score"]
    launches["int_flow_score"] = program["launches"]["int_flow_score"]
    timed("adapt", phase_adapt)
    launches["chimera_attention"] = timed("train", phase_train, recs)["launches"][
        "chimera_attention"]
    launches["window_attention"] = timed("serve", phase_serve, recs)["launches"]["window_attention"]
    timed("reference n_global=0", phase_reference, 0)
    timed("reference n_global=64", phase_reference, 64)
    timed("reference train", phase_reference_train)
    timed("reference serve", phase_reference_serve)
    timed("smoke configs", phase_smoke_configs)
    print(f"[done] {time.perf_counter() - t_start:.1f} s on {card}", flush=True)
    print(json.dumps({"kernels": kernel_lines(recs, launches)}), flush=True)
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
    return lines


if __name__ == "__main__":
    main()
