#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device    — requires CUDA; prints the card's name and power limit.
2. build     — builds the port's CUDA kernels from ``src/repro_torch/csrc``.
3. kernels   — holds each kernel against its plain PyTorch version on the
               card at the paper configuration's shapes and times both.
4. engine    — the main path: a ``FlowEngine`` at the paper's full width
               (chimera-dataplane: 4 layers, d 256, m 256, L 64, n_global
               64; capacity 4096, lanes 256) with random weights from a
               seed ingests protocol-mix and rule-violating batches.  The
               kernels' launch counters are zeroed just before and read
               just after.
5. reference — the same model on a small table, on the card and on the CPU
               (plain versions), must agree.

Then a JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.
It imports nothing of JAX and nothing of the JAX package.
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
FP32_FLOPS = 67e12  # float32 outside the tensor cores: both kernels use CUDA cores

SEED = 0
PKT_LEN = 16
LANES = 256
CAPACITY = 4096
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


def compare(name: str, got, want) -> float:
    """Max abs error; fails beyond ATOL + RTOL * |want| (exact for non-floats)."""
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
    bad = err > ATOL + RTOL * want.abs()
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


# --------------------------------------------------------------------------
# 3. kernels
# --------------------------------------------------------------------------

def decode_inputs(B, heads, Gq, d, dv, m, L, with_global, seed):
    """Random decode-step inputs; fill levels spread over 0..L-1 so folds happen."""
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
        "count": (torch.arange(B, dtype=torch.int32) % L).to("cuda"),
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


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_decode(with_global, timed):
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.kernels.decode_step import ops

    L, m = ARCH.chimera.chunk_size, ARCH.chimera.feature_map.m
    d = dv = ARCH.head_dim
    x = decode_inputs(LANES, ARCH.n_kv_heads, ARCH.n_heads // ARCH.n_kv_heads,
                      d, dv, m, L, with_global, SEED + int(with_global))
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
    log("kernels", f"decode_step BH={out_k.shape[0]} globals={with_global} folds={n_fold}: "
                   f"max abs err {err:.3e} (tolerance {ATOL:g} + {RTOL:g}*|ref|)")
    if timed:
        ms, call_ms = cuda_ms(lambda: run(ops.decode_step, ka), iters=50)
        plain_ms, plain_call_ms = cuda_ms(lambda: run(ops.decode_step_plain, pa), iters=20)
        nbytes, flops = decode_cost(x, L)
        bound_ms, bound_by = bound(nbytes, flops)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, call_ms=call_ms, plain_call_ms=plain_call_ms)
        log("kernels", f"decode_step device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                       f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} flop); "
                       f"per call from Python: kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms")
    return rec


def score_inputs(B, M, seed):
    import torch
    from repro_torch.configs.chimera_dataplane import CONFIG as ARCH
    from repro_torch.core.symbolic import RuleSet, words_to_int32

    g = torch.Generator().manual_seed(seed)
    d, K, W = ARCH.d_model, 8, 8
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


def check_score(M, timed):
    import torch
    from repro_torch.kernels.flow_ingest import ops

    params, rules, pooled, sig, sticky = score_inputs(LANES, M, SEED + M)
    out_k, st_k = ops.flow_score(params, rules, pooled, sig, sticky)
    out_p, st_p = ops.flow_score_plain(params, rules, pooled, sig, sticky)
    torch.cuda.synchronize()
    err = max(compare(f"flow_score {k}", out_k[k], out_p[k]) for k in out_p)
    compare("flow_score sticky", st_k, st_p)
    hard_hits = int(out_p["hard_hit"].sum())
    rec = {"max_abs_err": err}
    log("kernels", f"flow_score B={LANES} M={M} hard={hard_hits}: max abs err {err:.3e} "
                   f"(tolerance {ATOL:g} + {RTOL:g}*|ref|)")
    if timed:
        ms, call_ms = cuda_ms(lambda: ops.flow_score(params, rules, pooled, sig, sticky),
                              iters=200)
        plain_ms, plain_call_ms = cuda_ms(
            lambda: ops.flow_score_plain(params, rules, pooled, sig, sticky), iters=50)
        nbytes, flops = score_cost(params, rules, pooled, sig)
        bound_ms, bound_by = bound(nbytes, flops)
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, call_ms=call_ms, plain_call_ms=plain_call_ms)
        log("kernels", f"flow_score device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                       f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes} B, {flops} flop); "
                       f"per call from Python: kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms")
    return rec


def phase_kernels():
    recs = {}
    check_decode(with_global=False, timed=False)
    recs["decode_step"] = check_decode(with_global=True, timed=True)
    recs["flow_score"] = check_score(M=1, timed=True)
    check_score(M=300, timed=False)
    return recs


# --------------------------------------------------------------------------
# 4. engine (the main path)
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


def phase_engine(recs):
    import torch
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.kernels.decode_step import ops as dops
    from repro_torch.kernels.flow_ingest import ops as sops
    from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig
    from repro_torch.train import classifier as C

    ccfg, params = paper_classifier()
    batches, packets = 3, 256
    mix = FlowScenario(kind="protocol-mix", pkt_len=PKT_LEN, packets_per_batch=packets, seed=SEED)
    bad = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=packets,
                       seed=SEED, fid_base=1 << 32)
    rules = C.default_rules(ccfg, bad.anomaly_signature)
    torch.cuda.reset_peak_memory_stats()
    budget = torch.cuda.mem_get_info()[0]  # the table may hold what the card holds
    fcfg = FlowEngineConfig(capacity=CAPACITY, lanes=LANES, state_budget_bytes=budget)
    t0 = time.perf_counter()
    engine = FlowEngine(ccfg, params, rules, fcfg, device="cuda")
    log("engine", f"paper-config FlowEngine on cuda: capacity {CAPACITY}, lanes {LANES}, "
                  f"{engine.per_flow_state_bytes()} B/flow, resident_state_bytes "
                  f"{engine.resident_state_bytes()}, built in {time.perf_counter() - t0:.2f} s")

    def ingest(b):
        out = engine.ingest(b["flow_ids"], b["tokens"])
        P = len(b["flow_ids"])
        for k in ("trust", "s_nn", "s_sym"):
            if out[k].shape != (P,) or not np.isfinite(out[k]).all():
                fail(f"engine: {k} not finite of shape ({P},)")
        if not (out["trust"][out["vetoed"]] == 1.0).all():
            fail("engine: a vetoed packet has trust != 1.0")
        return out

    # the main path: counters zeroed just before, read just after
    dops.launches = sops.launches = 0
    ingest(mix.next_batch())  # warm-up
    torch.cuda.synchronize()
    n_pkts = 0
    rounds0 = engine.stats.rounds
    t0 = time.perf_counter()
    for _ in range(batches):
        b = mix.next_batch()
        ingest(b)
        n_pkts += len(b["flow_ids"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rounds = engine.stats.rounds - rounds0
    vetoed = sum(int(ingest(bad.next_batch())["vetoed"].sum()) for _ in range(2))
    b = mix.next_batch()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        ingest(b)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    launches = {"decode_step": dops.launches, "flow_score": sops.launches}
    n_batches = 1 + batches + 2 + 1

    if vetoed == 0:
        fail("engine: no packet of the rule-violating batches was vetoed")
    if min(launches.values()) == 0:
        fail(f"engine: a kernel was never launched on the main path: {launches}")
    pps = n_pkts / wall
    log("engine", f"{n_pkts} protocol-mix packets in {batches} batches, {rounds} arrival "
                  f"rounds, {wall:.3f} s: {pps:.1f} packets/s, "
                  f"{rounds / wall:.2f} rounds/s; rule-violating vetoes {vetoed}")
    log("engine", f"launches in the main-path run ({n_batches} batches, "
                  f"{engine.stats.rounds} rounds): {launches}; per batch "
                  + ", ".join(f"{k} {v / n_batches:.1f}" for k, v in launches.items())
                  + f"; per round decode_step {launches['decode_step'] / engine.stats.rounds:.1f}")
    for name, n in launches.items():
        per_batch = n / n_batches * recs[name]["ms"]
        log("engine", f"{name}: {per_batch:.3f} ms of kernel device time per batch "
                      f"(launches per batch x phase 3's CUDA-event device ms per launch)")
    report_profile(prof, prof_wall)
    report_ops_per_token(engine)
    log("engine", f"resident_state_bytes {engine.resident_state_bytes()}, "
                  f"max_memory_allocated {torch.cuda.max_memory_allocated()}")
    return {"pps": pps, "launches": launches}


def report_ops_per_token(engine):
    """PyTorch operator calls (each a dispatch on the host; the non-view ones
    launch device work) for one decode token through every layer."""
    import collections

    import torch
    from repro_torch.models import model as M
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func.__name__.split(".")[0]] += 1
            return func(*args, **(kwargs or {}))

    lanes = engine.fcfg.lanes
    dev = engine.device
    caches = M.init_caches(engine.ccfg.arch, lanes, device=dev)
    tok = torch.zeros((lanes,), dtype=torch.long, device=dev)
    pos = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    with Count() as c:
        M.decode_hidden_step(engine.ccfg.arch, engine.params["backbone"], tok, pos, caches)
    views = sum(n for k, n in c.ops.items()
                if k in ("view", "_unsafe_view", "unsqueeze", "permute", "select", "slice",
                         "transpose", "expand", "squeeze", "t", "reshape", "alias"))
    total = sum(c.ops.values())
    log("engine", f"PyTorch operator calls per decode token ({engine.ccfg.arch.n_layers} "
                  f"layers): {total}, of which {views} views; top: "
                  + ", ".join(f"{k} {n}" for k, n in c.ops.most_common(6)))


def report_profile(p, wall):
    """Device time by kernel for one profiled batch, and the device's busy share."""
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
        log("profile", "device time: not measured (the profiler reported none)")
        return
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log("profile", f"one protocol-mix batch: wall {wall * 1e3:.1f} ms, kernel time "
                   f"{busy_us / 1e3:.1f} ms, device busy share {busy_us / 1e3 / (wall * 1e3):.3f}")
    for dev_us, key, count in rows[:12]:
        log("profile", f"{dev_us / 1e3:9.3f} ms {count:7d}x  {key[:90]}")


# --------------------------------------------------------------------------
# 5. reference: the card against the plain versions on the CPU
# --------------------------------------------------------------------------

# card vs CPU, fp32 on both sides with other summation orders, through 4
# layers and up to 3 x 16 decode steps per flow.  Without the static-global
# tier every float agrees within 2e-4.  With it, a sign-LSH bit
# (x . proj > 0) of a query whose dot product is within rounding of 0 can
# flip between the two, which moves one global key across the Hamming
# threshold for one token and head: decisions stay identical, scores may
# move by up to 1e-2.
REFERENCE_TOL = {0: 2e-4, 64: 1e-2}


def phase_reference(n_global):
    from repro_torch.data.pipeline import FlowScenario
    from repro_torch.serve.flow_engine import FlowEngine, FlowEngineConfig
    from repro_torch.train import classifier as C

    ccfg, params = paper_classifier(n_global)
    sc = FlowScenario(kind="rule-violating", pkt_len=PKT_LEN, packets_per_batch=48, seed=SEED + 1)
    rules = C.default_rules(ccfg, sc.anomaly_signature)
    fcfg = FlowEngineConfig(capacity=24, lanes=16, state_budget_bytes=1 << 40, idle_timeout=2)
    gpu = FlowEngine(ccfg, params, rules, fcfg, device="cuda")
    cpu = FlowEngine(ccfg, params, rules, fcfg, device="cpu")
    tol = REFERENCE_TOL[n_global]
    worst = {k: 0.0 for k in ("trust", "s_nn", "s_sym")}
    vetoed = 0
    for _ in range(3):
        b = sc.next_batch()
        og = gpu.ingest(b["flow_ids"], b["tokens"])
        oc = cpu.ingest(b["flow_ids"], b["tokens"])
        for k in ("vetoed", "sig"):
            if not (og[k] == oc[k]).all():
                fail(f"reference: {k} differs between the card and the CPU")
        for k in worst:
            e = float(np.abs(og[k] - oc[k]).max())
            worst[k] = max(worst[k], e)
            if e > tol:
                fail(f"reference n_global={n_global}: {k} differs by {e:.3e} > {tol:g}")
        if not (og["trust"][og["vetoed"]] == 1.0).all():
            fail("reference: a vetoed packet has trust != 1.0")
        vetoed += int(og["vetoed"].sum())
    if gpu.stats != cpu.stats:
        fail(f"reference: stats differ {gpu.stats} vs {cpu.stats}")
    if gpu.table.slot_of != cpu.table.slot_of:
        fail("reference: the slot assignments differ")
    log("reference", f"n_global={n_global}: card vs CPU plain versions, 3 rule-violating "
                     f"batches: decisions identical ({vetoed} vetoes), max diffs "
                     + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
                     + f" (tolerance {tol:g}); stats {gpu.stats}")


# --------------------------------------------------------------------------

def main():
    t_start = time.perf_counter()
    card = phase_device()
    import torch

    phase_build()
    recs = phase_kernels()
    launches = phase_engine(recs)["launches"]
    phase_reference(n_global=0)
    phase_reference(n_global=64)
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
    }
    lines = []
    for name, (source, replaces) in info.items():
        r = recs[name]
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        })
    return lines


if __name__ == "__main__":
    main()
