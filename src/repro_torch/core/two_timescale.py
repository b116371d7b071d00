"""Two-timescale control-/data-plane protocol (port of
``repro.core.two_timescale``; paper §3.6, Eqs. 17-20).

* **Fast path (every tick)** — EMA statistics C(t) = (1−η)C(t−1) + η·u(t):
  the occupancy EMAs of Eq. 17 and the two-rate drift EWMAs that
  :class:`repro_torch.serve.adaptive_loop.AdaptiveLoop` keeps over the
  engine's outputs.  Plain torch on the tensors' device; the JAX package
  jits them, the port has no counterpart to jit and needs none.
* **Slow path (every T_cp)** — :class:`TwoTimescaleController`: recluster
  the harvested features with k-means, compute Δ_map, and compile an
  audited :class:`~repro_torch.compile.program.ProgramDelta` when the
  Eq. 20 gate opens.  It clusters on the device of the centroids it is
  given: the Trainer's lie on its device, the adaptation loop's on the
  host (numpy and CPU tensors), since that loop may run it on a thread
  beside the card's CUDA-graph captures, which any CUDA call from that
  thread would abort.
* **Install** — :func:`atomic_swap` rewrites the installed tensors in
  place, on the main thread between ticks: the fused engine's CUDA graphs
  captured their addresses, so a new tensor would never be read.  The
  copies go on the current stream, behind every replay already launched,
  which is what "between ticks" means on the card; Eq. 18's "device-ready"
  is a ``torch.cuda.synchronize()`` at the end.

k-means draws its first centroid as ``jax.random.randint(PRNGKey(seed),
(), 0, n)`` does: :func:`prng_key` and :func:`randint` are a numpy
threefry2x32 with JAX's default partitionable key derivation, so a
recluster picks the same seed point in both packages.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# threefry2x32: JAX's PRNGKey / randint, in numpy
# --------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = 0xFFFFFFFF


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: Tuple[int, int], count: Tuple[int, int]) -> Tuple[int, int]:
    """The 20-round threefry-2x32 block of (Salmon et al. 2011), as
    ``jax.random``'s ``threefry2x32_p`` computes it on one counter pair."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (int(count[0]) + ks[0]) & _M32
    x1 = (int(count[1]) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` (64-bit types off, JAX's default) for a
    seed in [0, 2^32)."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"prng_key: seed {seed} outside [0, 2^32)")
    return 0, seed


def _split2(key) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``jax.random.split(key)`` under ``jax_threefry_partitionable``: child
    ``i`` is the block of the counter pair ``(0, i)``."""
    return threefry2x32(key, (0, 0)), threefry2x32(key, (0, 1))


def _bits32(key) -> int:
    """32 random bits of shape (): one block of counter (0, 0), ``b0 ^ b1``."""
    b0, b1 = threefry2x32(key, (0, 0))
    return b0 ^ b1


def randint(key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` (int32): two draws
    reduced modulo the span, combined with ``2^16 mod span`` squared, all
    in wrapping uint32 arithmetic as JAX does it."""
    if maxval <= minval:
        return minval
    k1, k2 = _split2(key)
    hi, lo = _bits32(k1), _bits32(k2)
    span = (maxval - minval) & _M32
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    return minval + ((off & _M32) % span)


# --------------------------------------------------------------------------
# Fast path (Eq. 17)
# --------------------------------------------------------------------------

def ema_update(C: torch.Tensor, u: torch.Tensor, eta: float) -> torch.Tensor:
    """C(t) = (1-η)·C(t-1) + η·u(t), in this order of operations."""
    return (1.0 - eta) * C + eta * u


def occupancy_from_codes(codes: torch.Tensor, n_centroids: int) -> torch.Tensor:
    """u_j(t): fraction of tokens in this step assigned to centroid j."""
    onehot = torch.nn.functional.one_hot(codes.reshape(-1).long(), n_centroids)
    return onehot.float().mean(dim=0)


# --------------------------------------------------------------------------
# Slow path: k-means recluster
# --------------------------------------------------------------------------

def farthest_points(x: torch.Tensor, k: int, key) -> torch.Tensor:
    """The indices (k,) int64, on ``x``'s device, of the greedy
    farthest-point init: the first is ``randint(key, 0, n)``, drawn on the
    host; each next one is the argmax (first of equal maxima) of the
    squared distance to the nearest pick so far.  The picks stay device
    tensors, so the walk makes no host round trip."""
    n = x.shape[0]
    idx = torch.empty((k,), dtype=torch.long, device=x.device)
    idx[0] = randint(key, 0, n)
    d2 = torch.sum((x - x.index_select(0, idx[:1])) ** 2, dim=-1)
    for i in range(1, k):
        idx[i] = torch.argmax(d2)
        d2 = torch.minimum(d2, torch.sum((x - x.index_select(0, idx[i:i + 1])) ** 2, dim=-1))
    return idx


def lloyd(
    x: torch.Tensor,
    cent: torch.Tensor,
    iters: int,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from ``cent`` on ``x``'s device, in the JAX
    package's order of operations; returns (centroids, the last step's
    assignments)."""
    n, k = x.shape[0], cent.shape[0]
    w = (torch.ones((n,), device=x.device) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=x.device))
    classes = torch.arange(k, device=x.device)
    assign = torch.zeros((n,), dtype=torch.long, device=x.device)
    for _ in range(iters):
        dist = torch.sum(cent * cent, dim=-1)[None, :] - 2.0 * (x @ cent.T)
        assign = torch.argmin(dist, dim=-1)
        oh = (assign[:, None] == classes).float() * w[:, None]
        mass = torch.sum(oh, dim=0)
        sums = oh.T @ x
        cent = torch.where(mass[:, None] > 0, sums / torch.clamp(mass[:, None], min=1e-9), cent)
    return cent, assign


def kmeans(
    x,
    k: int,
    iters: int,
    key,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm with farthest-point init on ``x``'s device (a
    tensor's; a numpy array stays on the CPU); returns (centroids (k, d)
    float32, assignments (n,) int64) there.  ``key`` is a
    :func:`prng_key`: the first centroid is ``randint(key, 0, n)``."""
    if isinstance(x, torch.Tensor):
        x = x.float()
    else:
        x = torch.as_tensor(np.asarray(x, np.float32))
    cent = x.index_select(0, farthest_points(x, k, key))
    return lloyd(x, cent, iters, weights)


def delta_map(old_centroids: torch.Tensor, new_centroids: torch.Tensor) -> float:
    """Δ_map: mean relative centroid displacement (Eq. 20's similarity)."""
    num = torch.linalg.norm(new_centroids - old_centroids, dim=-1)
    den = torch.linalg.norm(old_centroids, dim=-1) + 1e-9
    return float(torch.mean(num / den))


# --------------------------------------------------------------------------
# Streaming drift statistics (the fast path of the adaptation loop)
# --------------------------------------------------------------------------
#
# Two-rate EWMAs (fast + slow) over per-class trust-score histograms, the
# class mix, veto and churn rates and packed-signature marker-bit
# frequencies.  Counts are sums of 0/1 values, exact in float32; the EWMA
# keeps the JAX package's order of operations.

@dataclasses.dataclass(frozen=True)
class DriftStatsConfig:
    n_classes: int
    n_bins: int = 8  # trust-score histogram bins over [0, 1]
    n_bits: int = 256  # packed-signature marker bits (32 * sig_words)
    eta_fast: float = 0.25  # memory ≈ 4 ingest batches
    eta_slow: float = 0.02  # memory ≈ 50 ingest batches (the baseline)


_EWMA_NAMES = ("class", "hist", "veto", "churn", "sig")


def init_drift_stats(cfg: DriftStatsConfig, device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed two-rate EWMA state on ``device``.  ``updates`` counts
    committed batches and drives the bias correction of :func:`_debiased`."""
    shapes = {"class": (cfg.n_classes,), "hist": (cfg.n_classes, cfg.n_bins), "veto": (),
              "churn": (), "sig": (cfg.n_bits,)}
    stats = {}
    for name, shape in shapes.items():
        for rate in ("fast", "slow"):
            stats[f"{name}_{rate}"] = torch.zeros(shape, dtype=torch.float32, device=device)
    stats["updates"] = torch.zeros((), dtype=torch.float32, device=device)
    return stats


def summarize_drift_chunk(
    cfg: DriftStatsConfig,
    pred: torch.Tensor,  # (L,) int predicted class per packet
    trust: torch.Tensor,  # (L,) float32 trust in [0, 1]
    vetoed: torch.Tensor,  # (L,) bool hard-veto verdicts
    sig: torch.Tensor,  # (L, W) int32 cumulative packed signatures (bit patterns)
    valid: torch.Tensor,  # (L,) bool — padding lanes carry False
) -> Dict[str, torch.Tensor]:
    """Masked count sums for one lane chunk; a batch's chunks are merged
    before one :func:`commit_drift`.  Signature words are int32 bit
    patterns: ``(sig >> s) & 1`` reads bit ``s`` of the word, bit 31
    included (the shift is arithmetic, the mask keeps one bit)."""
    v = valid.float()
    cls = torch.nn.functional.one_hot(pred.long(), cfg.n_classes).float() * v[:, None]
    bin_idx = torch.clamp((trust * cfg.n_bins).to(torch.int32), 0, cfg.n_bins - 1)
    bins = torch.nn.functional.one_hot(bin_idx.long(), cfg.n_bins).float()
    shifts = torch.arange(32, dtype=torch.int32, device=sig.device)
    bits = ((sig.to(torch.int32)[:, :, None] >> shifts) & 1).float()
    bits = bits.reshape(sig.shape[0], -1)[:, : cfg.n_bits]
    return {
        "n": torch.sum(v),
        "class": torch.sum(cls, dim=0),
        "hist": cls.T @ bins,  # (C, n_bins); cls already masked
        "veto": torch.sum(vetoed.float() * v),
        "sig": torch.sum(bits * v[:, None], dim=0),
    }


def merge_drift_summaries(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    return {k: a[k] + b[k] for k in a}


def commit_drift(cfg: DriftStatsConfig, stats: Dict[str, torch.Tensor],
                 summary: Dict[str, torch.Tensor], churn) -> Dict[str, torch.Tensor]:
    """One two-rate EWMA step per ingest batch (Eq. 17 on serving
    observables); ``churn`` is the fraction of the batch's packets that
    allocated a new flow-table entry.  Returns a new dict."""
    n = torch.clamp(summary["n"], min=1.0)
    obs = {
        "class": summary["class"] / n,
        "hist": summary["hist"] / n,
        "veto": summary["veto"] / n,
        "churn": torch.as_tensor(churn, dtype=torch.float32, device=n.device),
        "sig": summary["sig"] / n,
    }
    new = dict(stats)
    for name in _EWMA_NAMES:
        new[f"{name}_fast"] = ema_update(stats[f"{name}_fast"], obs[name], cfg.eta_fast)
        new[f"{name}_slow"] = ema_update(stats[f"{name}_slow"], obs[name], cfg.eta_slow)
    new["updates"] = stats["updates"] + 1.0
    return new


def _debiased(stats, cfg: DriftStatsConfig, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    t = torch.clamp(stats["updates"], min=1.0)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    cf = 1.0 - torch.pow((1.0 - cfg.eta_fast) * one, t)
    cs = 1.0 - torch.pow((1.0 - cfg.eta_slow) * one, t)
    return (
        stats[f"{name}_fast"] / torch.clamp(cf, min=1e-9),
        stats[f"{name}_slow"] / torch.clamp(cs, min=1e-9),
    )


def drift_metrics(cfg: DriftStatsConfig, stats) -> Dict[str, torch.Tensor]:
    """Scalar drift distances between the bias-corrected fast and slow
    EWMAs: what the serve-layer drift policy thresholds against."""
    class_f, class_s = _debiased(stats, cfg, "class")
    hist_f, hist_s = _debiased(stats, cfg, "hist")
    veto_f, veto_s = _debiased(stats, cfg, "veto")
    churn_f, churn_s = _debiased(stats, cfg, "churn")
    sig_f, sig_s = _debiased(stats, cfg, "sig")
    # per-class score-histogram TV, weighted by the slow class mass so empty
    # classes contribute nothing
    hf = hist_f / torch.clamp(torch.sum(hist_f, dim=1, keepdim=True), min=1e-9)
    hs = hist_s / torch.clamp(torch.sum(hist_s, dim=1, keepdim=True), min=1e-9)
    w = class_s / torch.clamp(torch.sum(class_s), min=1e-9)
    return {
        "class_dist": 0.5 * torch.sum(torch.abs(class_f - class_s)),
        "hist_dist": torch.sum(w * 0.5 * torch.sum(torch.abs(hf - hs), dim=1)),
        "veto_shift": torch.abs(veto_f - veto_s),
        "churn_shift": torch.abs(churn_f - churn_s),
        "sig_novelty": torch.max(torch.clamp(sig_f - sig_s, min=0.0)),
    }


def novel_signature_bits(cfg: DriftStatsConfig, stats, threshold: float) -> torch.Tensor:
    """(n_bits,) bool — marker bits whose recent frequency exceeds the
    long-run baseline by more than ``threshold``."""
    sig_f, sig_s = _debiased(stats, cfg, "sig")
    return (sig_f - sig_s) > threshold


# --------------------------------------------------------------------------
# Controller
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTimescaleConfig:
    eta: float = 0.1  # EMA smoothing (Eq. 17); memory depth ≈ 1/η steps
    t_cp_steps: int = 60  # control-plane epoch, in steps (T_cp)
    tau_map: float = 0.02  # churn gate (Eq. 20)
    kmeans_iters: int = 8
    install_seconds_per_entry: float = 5e-6  # empirical Tofino-class rate
    t_cp_seconds: float = 60.0  # wall-clock T_cp for the Eq. 18 check


@dataclasses.dataclass
class InstallRecord:
    step: int
    delta_map: float
    installed: bool
    n_entries: int
    install_seconds: float
    churn_ok: bool  # Eq. 18 satisfied


class TwoTimescaleController:
    """The slow path: owns a host reservoir of sampled features and decides,
    per control-plane epoch, whether the recluster moved enough to install.
    k-means runs where the caller's centroids lie: with CPU centroids the
    controller touches no CUDA tensor (see the module docstring)."""

    def __init__(self, cfg: TwoTimescaleConfig, n_centroids: int):
        self.cfg = cfg
        self.n_centroids = n_centroids
        self.history: List[InstallRecord] = []
        self._reservoir: List[np.ndarray] = []
        self._reservoir_cap = 64

    def observe(self, features) -> None:
        """Collect a host sample batch for the next recluster (reservoir)."""
        f = np.asarray(features)
        self._reservoir.append(f.reshape(-1, f.shape[-1]))
        if len(self._reservoir) > self._reservoir_cap:
            self._reservoir.pop(0)

    def maybe_recluster(
        self,
        step: int,
        centroids: torch.Tensor,
        occupancy,
        key,
        *,
        program=None,
        new_weights=None,
        new_ruleset=None,
    ):
        """Run the slow path if a control-plane epoch boundary was reached.

        Returns (possibly-new centroids, install record or None), and with
        ``program`` a third element: the :class:`~repro_torch.compile
        .ProgramDelta` of ``new_weights`` / ``new_ruleset`` compiled against
        it (the same audited passes as the deployment), or None when the
        Eq. 20 gate held the update back.  ``key`` is a :func:`prng_key`.
        The reservoir is clustered on ``centroids``' device, where the new
        centroids lie.  ``occupancy`` is accepted for the JAX package's
        signature; the recluster is unweighted there too.
        """
        if step == 0 or step % self.cfg.t_cp_steps != 0 or not self._reservoir:
            return (centroids, None) if program is None else (centroids, None, None)
        samples = torch.from_numpy(np.concatenate(self._reservoir, axis=0)).to(centroids.device)
        new_cent, _ = kmeans(samples, self.n_centroids, self.cfg.kmeans_iters, key)
        dm = delta_map(centroids, new_cent)
        n_entries = self.n_centroids
        install_s = n_entries * self.cfg.install_seconds_per_entry
        churn_ok = install_s < self.cfg.t_cp_seconds  # Eq. 18
        installed = bool(dm > self.cfg.tau_map and churn_ok)  # Eq. 20 gate
        rec = InstallRecord(step=step, delta_map=dm, installed=installed, n_entries=n_entries,
                            install_seconds=install_s, churn_ok=churn_ok)
        self.history.append(rec)
        cent_out = new_cent if installed else centroids
        if program is None:
            return cent_out, rec
        delta = None
        if installed:
            from repro_torch.compile.program import compile_delta  # no core -> compile cycle

            delta = compile_delta(program, weights=new_weights, ruleset=new_ruleset, step=step)
        return cent_out, rec, delta


# --------------------------------------------------------------------------
# Install (Eq. 18)
# --------------------------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    if hasattr(tree, "tensors"):  # RuleSet
        return list(tree.tensors())
    raise TypeError(f"atomic_swap: no tensors in a {type(tree).__name__}")


def _sync(tensors: List[torch.Tensor]) -> None:
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def atomic_swap(installed, new):
    """Copy every tensor of ``new`` into the matching tensor of ``installed``
    (same structure, shapes and dtypes) in place; returns ``installed`` once
    the copies are device-ready."""
    dst, src = _leaves(installed), _leaves(new)
    if len(dst) != len(src):
        raise ValueError(f"atomic_swap: {len(src)} tensors for {len(dst)} installed ones")
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"atomic_swap: {tuple(s.shape)}/{s.dtype} into an installed "
                             f"{tuple(d.shape)}/{d.dtype}")
        if d is not s:
            d.copy_(s)
    _sync(dst)
    return installed


def measure_install_time(fn, *args) -> float:
    """Wall-clock seconds of ``fn(*args)`` until its tensors are device-ready."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(_leaves(out))
    return time.perf_counter() - t0
