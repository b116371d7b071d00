"""Batched LM serving engine (port of ``repro.serve.engine``: ``ServeStats``
:31, ``Request`` :41 and ``ServeEngine`` :50).

Slot-based continuous batching over the non-iterative ``decode_step``:
``submit`` queues a prompt, every ``step()`` fills free slots and decodes one
token for all active slots (prompt tokens are teacher-forced through the
same step), and ``prefill_batch`` ingests a batch of prompts in one forward
(``prefill_with_caches``: Chimera's chunked prefill through the
``chimera_attention`` kernel, or the softmax SWA path through the
``window_attention`` kernel).  Greedy or temperature sampling; slots free on
EOS or at the length cap.

The engine runs on one device, ``"cuda"`` unless the caller asks for the
CPU; its parameters must lie there.  The caches live on that device and are
updated in place.  Temperature sampling draws from an explicit
``torch.Generator`` (another stream of numbers than ``jax.random``).
The deploy surface builds it for a program's backbone
(``program.deploy(DeploySpec(engine="lm"))``, :mod:`repro_torch.serve.deploy`);
``ServeEngine.from_program`` is the JAX package's deprecated shim over it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.chimera_attention import ChimeraState
from repro_torch.models import model as M
from repro_torch.optim.optimizer import tree_flatten


@dataclasses.dataclass
class ServeStats:
    """LM slot-engine counters."""

    ticks: int = 0
    tokens_emitted: int = 0
    requests_completed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: int = -1  # -1: never
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _cache_leaves(caches) -> List[torch.Tensor]:
    out = []
    for c in caches.values():
        out.extend(c.leaves() if isinstance(c, ChimeraState) else c.values())
    return out


class ServeEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params,
        batch_slots: int = 8,
        max_len: int = 4096,
        temperature: float = 0.0,
        seed: int = 0,
        device=None,
    ):
        M.refuse_encdec(cfg, "ServeEngine")
        self.device = resolve_device(device, "ServeEngine")
        for leaf in tree_flatten(params)[0]:
            if leaf.device.type != self.device.type:
                raise ValueError(f"ServeEngine: a parameter lies on {leaf.device}, the engine "
                                 f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator().manual_seed(seed)
        self.caches = M.init_caches(cfg, batch_slots, max_len, dtype=torch.float32,
                                    device=self.device)
        self.positions = np.zeros((batch_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.pending: List[Request] = []
        self._next_token = np.zeros((batch_slots,), np.int32)
        self.stats = ServeStats()

    # ------------------------------------------------------------------
    # the flow-serving surface, which this engine does not have
    # ------------------------------------------------------------------
    def ingest(self, flow_ids, tokens):
        raise NotImplementedError(
            "the LM slot engine serves token requests (submit/step), not packet flows; "
            "use FlowEngine for flow ingest"
        )

    def flow_scores(self, fid: int):
        raise NotImplementedError(
            "the LM slot engine keeps no flow table; use FlowEngine for flow scores"
        )

    def swap_tables(self, ruleset=None, weights=None, weight_spec=None, delta=None):
        raise NotImplementedError(
            "the LM slot engine carries no rule tables; table swaps apply to the "
            "flow-serving engines"
        )

    def capture_entry_points(self) -> Dict:
        """None: the decode tick runs eagerly and captures no graph, so the
        graph-capture sentry has nothing to count here."""
        return {}

    # ------------------------------------------------------------------
    # compiled-program deployment (the JAX package's deprecated shim)
    # ------------------------------------------------------------------
    @classmethod
    def from_program(cls, program, **kwargs) -> "ServeEngine":
        """Deprecated: deploy through the one front door instead,
        ``program.deploy(DeploySpec(engine="lm", batch_slots=...))``."""
        warnings.warn(
            "ServeEngine.from_program is deprecated; use "
            "DataplaneProgram.deploy(DeploySpec(engine='lm', batch_slots=..., "
            "max_len=...))",
            DeprecationWarning, stacklevel=2,
        )
        from repro_torch.serve.deploy import build_serve_engine

        return build_serve_engine(program, **kwargs)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _fill_slots(self) -> None:
        for i in range(self.slots):
            if self.active[i] is None and self.pending:
                req = self.pending.pop(0)
                self.active[i] = req
                self.positions[i] = 0
                self._next_token[i] = req.prompt[0]
                # per-slot state reset: zero this slot of every cache leaf
                # (axis 1, after the stacked layer axis), in place
                for c in _cache_leaves(self.caches):
                    if c.dim() >= 2 and c.shape[1] == self.slots:
                        c[:, i].zero_()

    # ------------------------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """One engine tick: decode one token for every active slot."""
        self._fill_slots()
        if not any(r is not None for r in self.active):
            return {}
        tokens = torch.from_numpy(self._next_token.astype(np.int64)).to(self.device)
        positions = torch.from_numpy(self.positions.copy()).to(self.device)
        with torch.no_grad():
            logits = M.decode_step(self.cfg, self.params, tokens, positions, self.caches)
        logits = logits.float().cpu().numpy()
        self.stats.ticks += 1
        emitted: Dict[int, List[int]] = {}
        V = self.cfg.vocab_size
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.positions[i] += 1
            pos = int(self.positions[i])
            if pos < len(req.prompt):
                # still ingesting the prompt (teacher forcing)
                self._next_token[i] = req.prompt[pos]
                continue
            if self.temperature > 0:
                # sample over the real vocab only: the head is padded
                probs = torch.softmax(torch.from_numpy(logits[i][:V]) / self.temperature, -1)
                nxt = int(torch.multinomial(probs, 1, generator=self.generator))
            else:
                nxt = int(np.argmax(logits[i][:V]))
            req.generated.append(nxt)
            emitted.setdefault(req.rid, []).append(nxt)
            self._next_token[i] = nxt
            self.stats.tokens_emitted += 1
            if (
                nxt == req.eos_id
                or len(req.generated) >= req.max_new_tokens
                or pos >= self.max_len - 1
            ):
                req.done = True
                self.active[i] = None
                self.stats.requests_completed += 1
        return emitted

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.pending and all(r is None for r in self.active):
                return
            self.step()
        left = len(self.pending) + sum(r is not None for r in self.active)
        if left:
            raise RuntimeError(
                f"run_until_done: {left} request(s) still unfinished after "
                f"{max_ticks} ticks (raise max_ticks or check eos/length caps)"
            )

    # ------------------------------------------------------------------
    def prefill_batch(self, requests) -> None:
        """Ingest the prompts of a batch of slots in one forward
        (``prefill_with_caches``) instead of token-by-token teacher forcing.
        Every slot is prefilled to the shortest prompt's length less one; the
        rest of each prompt, and its last token, go through ``step``."""
        if len(requests) > self.slots:
            raise ValueError("more requests than slots")
        min_len = min(len(r.prompt) for r in requests)
        pre = max(0, min_len - 1)
        if pre > 0:
            batch_tokens = np.zeros((self.slots, pre), np.int64)
            for i, r in enumerate(requests):
                batch_tokens[i] = r.prompt[:pre]
            with torch.no_grad():
                _, caches = M.prefill_with_caches(
                    self.cfg, self.params, torch.from_numpy(batch_tokens).to(self.device),
                    max_len=self.max_len,
                )
            # the caches keep the engine's dtypes (prefill runs in the model's)
            for dst, src in zip(_cache_leaves(self.caches), _cache_leaves(caches)):
                dst.copy_(src)
            del caches
        for i, r in enumerate(requests):
            self.active[i] = r
            self.positions[i] = pre
            self._next_token[i] = r.prompt[pre]
