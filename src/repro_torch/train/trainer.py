"""Trainer: the training loop wiring every subsystem together (port of
``repro.train.trainer``).

Per step: resumable data stream → tensors on the device → train step
(:func:`repro_torch.train.train_step.make_train_step`, or a custom loss) →
metrics.  Around it: atomic checkpoints written on a thread, heartbeat and
straggler bookkeeping, and the paper's **two-timescale protocol** (§3.6):
the fast path keeps an EMA of the Chimera codebook's occupancy every step;
every ``t_cp_steps`` the control plane reclusters the codebook from a host
feature reservoir (k-means on the trainer's device), gates the install on
Δ_map > τ_map (Eq. 20) and the Δt_install < T_cp check (Eq. 18), and swaps
the new centroids into the parameter tree in place
(:func:`~repro_torch.core.two_timescale.atomic_swap`).

The parameters are drawn from a CPU ``torch.Generator`` seeded with
``TrainerConfig.seed`` and moved to the device, so the card and the CPU
start from the same weights, unless the caller gives them (``params=``, a
tree on the device: a full-width model is drawn on the card, where its
billions of host normals would take minutes).  Each step donates the old
parameters and optimizer state to the update (``adamw_update(...,
donate=True)``), which releases them leaf by leaf: the old and the new
trees never coexist whole.  They are not the JAX package's draws: to
start from those, assign ``params_from_jax``'s tree (and, for a JAX
optimizer state, its ``m``, ``v`` and ``step``) to ``tr.params`` and
``tr.opt_state`` before :meth:`Trainer.run`.  Checkpoints are the JAX
package's layout, so either package's ``Trainer`` resumes the other's.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ArchConfig
from repro_torch.core.feature_maps import _normalize, assign_codes
from repro_torch.core.two_timescale import (
    TwoTimescaleConfig,
    TwoTimescaleController,
    atomic_swap,
    ema_update,
    occupancy_from_codes,
    prng_key,
)
from repro_torch.models import model as M
from repro_torch.models.layers import embed
from repro_torch.optim.optimizer import AdamWConfig, adamw_update, init_optimizer
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, StragglerDetector
from repro_torch.train.classifier import batch_to_device
from repro_torch.train.train_step import cast_for_compute, make_train_step, value_and_grad

# tokens per sequence that feed the codebook's occupancy and reservoir
_CODEBOOK_TOKENS = 64


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    # the port's own directory, never a JAX run's (``/tmp/repro_ckpt``)
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    seed: int = 0
    two_timescale: Optional[TwoTimescaleConfig] = None
    resume: bool = True


class Trainer:
    """``Trainer(arch, tcfg, stream, opt_cfg=None, loss_fn=None, device=None,
    params=None)``: ``loss_fn(params, batch) -> (loss, metrics)`` replaces
    the LM objective; ``device=None`` means ``"cuda"`` and raises without a
    GPU; ``params`` (on the device) replaces the seeded draw.  Resumes
    from the latest checkpoint in ``tcfg.ckpt_dir`` unless
    ``tcfg.resume`` is off."""

    def __init__(
        self,
        arch: ArchConfig,
        tcfg: TrainerConfig,
        stream,
        opt_cfg: Optional[AdamWConfig] = None,
        loss_fn: Optional[Callable] = None,
        device=None,
        params=None,
    ):
        self.arch = arch
        self.tcfg = tcfg
        self.stream = stream
        self.device = resolve_device(device, "Trainer")
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=tcfg.total_steps)
        if params is None:
            params = M.init_model(arch, torch.Generator().manual_seed(tcfg.seed), self.device)
        self.params = params
        self.opt_state = init_optimizer(self.params, self.opt_cfg)
        self.step = 0
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.heartbeats = HeartbeatMonitor()
        self.stragglers = StragglerDetector()
        self.metrics_log: list = []

        if loss_fn is None:
            self._step_fn = make_train_step(arch, self.opt_cfg, donate=True)
        else:
            def step_fn(params, opt_state, batch):
                (loss, metrics), grads = value_and_grad(
                    lambda p: loss_fn(cast_for_compute(arch, p), batch), params)
                new_p, new_o, om = adamw_update(self.opt_cfg, params, grads, opt_state,
                                                donate=True)
                return new_p, new_o, {**metrics, **om, "loss": loss}

            self._step_fn = step_fn

        # two-timescale controller over the Chimera codebook (when present)
        self.controller: Optional[TwoTimescaleController] = None
        if tcfg.two_timescale is not None:
            n_cent = arch.chimera.feature_map.codebook_size
            self.controller = TwoTimescaleController(tcfg.two_timescale, n_cent)
            self._occupancy = torch.zeros((n_cent,), device=self.device)

        if tcfg.resume and self.ckpt.latest_step() is not None:
            self.restore()

    # ------------------------------------------------------------------
    def restore(self) -> None:
        tree = {"params": self.params, "opt": self.opt_state}
        restored, extra, step = self.ckpt.restore(tree)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = step
        if "data_state" in extra:
            self.stream.restore(extra["data_state"])

    def save(self, blocking: bool = False) -> None:
        self.ckpt.save(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            extra={"data_state": self.stream.state()},
            blocking=blocking,
        )

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train up to step ``steps`` (``total_steps`` by default), then
        save blocking.  ``step_seconds`` in the log is the host clock
        between steps: the device runs behind it, as XLA's does."""
        steps = steps or self.tcfg.total_steps
        t_last = time.perf_counter()
        while self.step < steps:
            batch = batch_to_device(self.stream.next_batch(), self.device)
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            self.heartbeats.beat(worker=0, step=self.step)
            self.stragglers.record(worker=0, step_seconds=dt)
            if self.controller is not None:
                self._two_timescale_tick(batch)
            if self.step % self.tcfg.log_every == 0:
                row = {k: float(v) for k, v in metrics.items()}
                row["step"] = self.step
                row["step_seconds"] = dt
                self.metrics_log.append(row)
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
        self.save(blocking=True)
        return {"step": self.step, "log": self.metrics_log}

    # ------------------------------------------------------------------
    def _two_timescale_tick(self, batch) -> None:
        """Fast path: EMA occupancy (Eq. 17).  Slow path on an epoch boundary."""
        cfg = self.arch.chimera
        if cfg.feature_map.kind != "codebook":
            return
        fm = self._codebook_params()
        if fm is None:
            return
        d_code = fm["centroids"].shape[-1]  # the codebook lives in head space
        # sample features: token embeddings of this batch folded into
        # head-width slices (a cheap proxy for the per-layer q/k features;
        # the reservoir feeds the recluster)
        emb = embed(self.params["embed"], batch["tokens"][:, :_CODEBOOK_TOKENS])
        feats = _normalize(emb.reshape(-1, d_code), cfg.feature_map.input_scale)
        codes = assign_codes(fm["centroids"][0], feats)
        occ = occupancy_from_codes(codes, self.controller.n_centroids)
        self._occupancy = ema_update(self._occupancy, occ, self.controller.cfg.eta)
        # the reservoir is host memory (as the JAX Trainer's np.asarray copy);
        # the controller clusters it where the centroids lie, on this device
        self.controller.observe(feats.detach().cpu().numpy())
        new_cent, rec = self.controller.maybe_recluster(
            self.step, fm["centroids"][0], self._occupancy, prng_key(self.step))
        if rec is not None and rec.installed:
            atomic_swap(fm["centroids"], new_cent[None].expand(fm["centroids"].shape))

    def _codebook_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """Layer group 0's codebook (stacked over the layer axis), or None."""
        try:
            return self.params["blocks"]["b0"]["attn"]["chimera"]["fm"]
        except (KeyError, TypeError):
            return None
