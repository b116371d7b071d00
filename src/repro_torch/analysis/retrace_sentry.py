"""Graph-capture sentry: a capture-count auditor for the serving engines'
hot paths (port of ``repro.analysis.retrace_sentry``).

The JAX package's failure mode is a mid-stream retrace: a shape or dtype
wobble recompiles the step function and stalls the dataplane while packets
queue.  The port's counterpart is what it compiles at run time: the fused
engine captures one CUDA graph of its flow step per ``(width, pkt_len)``
(:class:`repro_torch.kernels.flow_ingest.fused.FlowStepGraphs`), at a
width's first chunk unless ``warm_fused`` captured it first.  A capture in
steady state is a host stall of a warm-up run plus the capture itself.

The sentry counts the keys each named entry point exposes
(:class:`repro_torch.serve.flow_engine.CaptureKeys`): on the card the fused
step's keys are its captured graphs; on the CPU nothing is captured, and the
same entry points count the keys the step has run at, so the CPU sees the
deltas the card does.  The per-round step's key is its launch shape.

Usage::

    sentry = RetraceSentry.for_engine(engine)   # named entry points
    engine.ingest(...)                          # warm-up captures are fine
    sentry.snapshot()                           # freeze the baseline
    with sentry.expect_no_retrace():            # audited region
        engine.ingest(...)

``RetraceError`` names the entry point that grew and by how much.  The
sentry only reads key sets, so it cannot perturb what it measures.
"""

from __future__ import annotations

from typing import Dict, Optional


class RetraceError(AssertionError):
    """An entry point captured (or ran at) a new key inside an audited region."""

    def __init__(self, message: str, deltas: Dict[str, int]):
        super().__init__(message)
        self.deltas = deltas


class RetraceSentry:
    """Audits the capture counts of named entry points."""

    def __init__(self, targets: Dict[str, object]):
        for name, ep in targets.items():
            if not hasattr(ep, "capture_count"):
                raise TypeError(f"target {name!r} is not a capture entry point "
                                f"(no capture_count): {type(ep).__name__}")
        self._targets = dict(targets)
        self._baseline: Optional[Dict[str, int]] = None
        self.snapshot()

    @classmethod
    def for_engine(cls, engine, prefix: str = "") -> "RetraceSentry":
        """Sentry over every entry point ``engine.capture_entry_points()``
        names (an :class:`~repro_torch.serve.adaptive_loop.AdaptiveLoop`'s
        come from its inner engine, namespaced ``engine.``; an elastic
        service's from every cached topology, ``shards<N>.``)."""
        entries = getattr(engine, "capture_entry_points", None)
        targets = {prefix + name: ep for name, ep in (entries() if entries else {}).items()}
        if not targets:
            raise ValueError(f"{type(engine).__name__} exposes no entry points that capture "
                             f"graphs")
        return cls(targets)

    def counts(self) -> Dict[str, int]:
        """Current capture count per entry point."""
        return {name: int(ep.capture_count()) for name, ep in self._targets.items()}

    def snapshot(self) -> Dict[str, int]:
        """Freeze the baseline the next assertion compares against."""
        self._baseline = self.counts()
        return dict(self._baseline)

    def deltas(self) -> Dict[str, int]:
        """Captures since the last snapshot, per entry point."""
        assert self._baseline is not None
        now = self.counts()
        return {name: now[name] - self._baseline.get(name, 0) for name in now}

    def assert_no_retrace(self) -> None:
        """Raise :class:`RetraceError` if any entry point captured since the
        snapshot; on success the baseline advances."""
        grown = {n: d for n, d in self.deltas().items() if d > 0}
        if grown:
            rows = ", ".join(f"{n}: +{d}" for n, d in sorted(grown.items()))
            raise RetraceError(
                f"mid-stream capture detected ({rows}) — the hot path saw a new "
                f"(width, pkt_len) key inside an audited region", grown)
        self.snapshot()

    def assert_total_traces(self, limit: int) -> None:
        """Assert the absolute capture count across all entry points is at
        most ``limit`` (warm-up budget audits)."""
        counts = self.counts()
        total = sum(counts.values())
        if total > limit:
            raise RetraceError(f"trace budget exceeded: {total} total captures > {limit} "
                               f"({counts})", counts)

    def expect_no_retrace(self) -> "_NoRetraceRegion":
        """Context manager: snapshot on entry, assert on clean exit."""
        return _NoRetraceRegion(self)


class _NoRetraceRegion:
    def __init__(self, sentry: RetraceSentry):
        self._sentry = sentry

    def __enter__(self) -> RetraceSentry:
        self._sentry.snapshot()
        return self._sentry

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._sentry.assert_no_retrace()
        return False
