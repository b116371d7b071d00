"""Integer interval abstract interpretation over the lowered score graph
(port of ``repro.analysis.intervals``).

The int-lowering pass (:mod:`repro_torch.compile.int_lowering`)
hand-derives worst-case bit widths for its accumulators, recorded as
``int-lowering`` ledger rows against the 32-bit ALU.  This module re-derives
them mechanically: it walks the traced aten graph of the lowered score
program (:func:`repro_torch.compile.int_lowering.score_graph`) node by node,
propagating a sound ``[lo, hi]`` interval per value from the declared input
ranges (the Eq. 39 horizon bound on the feature accumulator, the compiled
tables' min and max, the full word range for signatures), and proves that
no integer node can mathematically exceed its dtype: no int32 wraparound is
reachable at the declared horizon, for any input the contract admits.  A
provable overflow raises :class:`AnalysisError` before anything executes.

Soundness over precision: an operator the transfer functions do not model
gets the full range of its output dtype, so an unmodelled op can cause a
false alarm but never a false proof.  Control flow (``cond``,
``while_loop``) is not entered: it falls to that default, as in the JAX
package.

**What the proof covers on the card.**  The proof reads the plain version
of the score stage, :func:`~repro_torch.compile.int_lowering
.int_flow_score`.  The card runs ``csrc/int_flow_score.cu`` instead, which
the program phase of ``chip_smoke.py`` holds bit for bit against that plain
version (adversarial edge inputs included).  That equality is what carries
the proof over to the kernel: a kernel that equals the plain version on
every input overflows where it does, and it does not.

The port's signature and rule words are int32 bit patterns where the JAX
package's are uint32.  An input declared with ``Interval(..., words=True)``
is read unsigned, as the JAX package's uint32 words are; bitwise operators
and shape operators keep that reading, and such values are reported with
dtype ``uint32`` (so, as in the JAX package, they never count toward an
accumulator's width).
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.graph_lint import op_name


class AnalysisError(ValueError):
    """A static analysis proved (or could not exclude) a safety violation.

    Raised before any execution — by the interval analyzer on a provable
    integer overflow, or by the verify pass on a fatal lint finding.
    Carries the machine-readable report so callers can render the audit."""

    def __init__(self, message: str, report=None):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass(frozen=True)
class Interval:
    """A closed integer interval [lo, hi] in exact (Python int) arithmetic,
    so propagation itself can never overflow.  ``words``: the value is a
    32-bit pattern read unsigned (see the module docstring)."""

    lo: int
    hi: int
    words: bool = False

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @property
    def magnitude(self) -> int:
        return max(abs(self.lo), abs(self.hi))

    @property
    def signed_bits(self) -> int:
        """Bits of the smallest signed word holding every value."""
        if self.lo == 0 and self.hi == 0:
            return 1
        need = 1
        while not (-(1 << (need - 1)) <= self.lo and self.hi <= (1 << (need - 1)) - 1):
            need += 1
        return need

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi),
                        self.words and other.words)

    def __repr__(self) -> str:
        return f"[{self.lo}, {self.hi}]"


WORD = Interval(0, (1 << 32) - 1, words=True)  # any 32-bit pattern, read unsigned


def _dname(dtype, iv: Interval) -> str:
    """The dtype a row reports: ``uint32`` for int32 words read unsigned."""
    if iv.words and dtype == torch.int32:
        return "uint32"
    return str(dtype).removeprefix("torch.")


def _range_of(name: str) -> Interval:
    """Every value of the dtype named ``name``."""
    if name == "bool":
        return Interval(0, 1)
    if name.startswith(("int", "uint")):
        info = np.iinfo(np.dtype(name))
        return Interval(int(info.min), int(info.max))
    # float values appear at the audited region's boundary (the unused f32
    # rule weights); give them a nominal range: only integer dtypes are checked
    return Interval(-(1 << 62), 1 << 62)


def _dtype_interval(dtype) -> Interval:
    return _range_of(str(dtype).removeprefix("torch."))


def _is_int_dtype(name: str) -> bool:
    return name.startswith(("int", "uint"))


def _fits(iv: Interval, name: str) -> bool:
    d = _range_of(name)
    return d.lo <= iv.lo and iv.hi <= d.hi


def _clip(iv: Interval, name: str) -> Interval:
    d = _range_of(name)
    return Interval(max(iv.lo, d.lo), min(iv.hi, d.hi), iv.words)


@dataclasses.dataclass(frozen=True)
class EqnBound:
    """One node's proven output range."""

    primitive: str
    dtype: str
    interval: Interval
    signed_bits: int
    overflows: bool  # mathematical range exceeds the result dtype


@dataclasses.dataclass
class IntervalReport:
    """The machine-checked width audit of one lowered score graph."""

    bounds: List[EqnBound]
    inputs: List[EqnBound]  # declared input ranges (checked against dtype too)

    @property
    def max_signed_bits(self) -> int:
        """Widest word any signed-integer input or node needs — the machine
        analog of the ledger's hand-derived accumulator widths (unsigned
        signature words excluded: a full 32-bit pattern is not an
        accumulator claim)."""
        rows = [b for b in self.bounds + self.inputs if b.dtype.startswith("int")]
        return max((b.signed_bits for b in rows), default=1)

    def overflows(self) -> List[EqnBound]:
        return [b for b in self.bounds + self.inputs if b.overflows]

    def proves_no_overflow(self) -> bool:
        return not self.overflows()

    def as_dict(self) -> Dict:
        def row(b: EqnBound) -> Dict:
            return {
                "primitive": b.primitive, "dtype": b.dtype,
                "lo": b.interval.lo, "hi": b.interval.hi,
                "signed_bits": b.signed_bits, "overflows": b.overflows,
            }

        return {
            "max_signed_bits": self.max_signed_bits,
            "proves_no_overflow": self.proves_no_overflow(),
            "inputs": [row(b) for b in self.inputs],
            "eqns": [row(b) for b in self.bounds],
        }


@dataclasses.dataclass(frozen=True)
class SumBound:
    """A relational input fact: input ``numerator`` is (element-wise) a sum
    of ``denominator``-many terms, each of magnitude <= ``term_bound``.

    This is the Eq. 39 streaming invariant — ``hidden_sum`` is the sum of
    ``count`` quantized features — and it is the fact a non-relational
    interval domain loses at the mean division ``hidden_sum //
    max(count, 1)``: the quotient is bounded by ``term_bound``."""

    numerator: int  # flat input index of the running sum
    denominator: int  # flat input index of the term count
    term_bound: int  # per-term magnitude bound


# --------------------------------------------------------------------------
# transfer functions
# --------------------------------------------------------------------------

def _mul_iv(a: Interval, b: Interval) -> Interval:
    cands = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
    return Interval(min(cands), max(cands))


def _div_candidates(a: Interval, b: Interval, op) -> Interval:
    """Corner evaluation for division-family ops; divisor values of 0 are
    excluded (the lowered program guards with max(count, 1))."""
    divisors = [d for d in (b.lo, b.hi, 1, -1) if b.lo <= d <= b.hi and d != 0] or [1]
    cands = [op(n, d) for n in (a.lo, a.hi, 0) if a.lo <= n <= a.hi for d in divisors]
    return Interval(min(cands), max(cands))


def _tdiv(n: int, d: int) -> int:
    """Truncating division (round toward zero)."""
    q = abs(n) // abs(d)
    return q if (n >= 0) == (d >= 0) else -q


def _shift(a: Interval, k: Interval, left: bool) -> Interval:
    ks = sorted({max(k.lo, 0), max(k.hi, 0)})
    cands = [(v << s) if left else (v >> s) for v in (a.lo, a.hi) for s in ks]
    return Interval(min(cands), max(cands))


def _sum_interval(term: Interval, n: int) -> Interval:
    return Interval(min(term.lo * n, 0), max(term.hi * n, 0))


def _const_interval(x) -> Interval:
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if arr.size == 0:
        return Interval(0, 0)
    if arr.dtype == np.bool_ or np.issubdtype(arr.dtype, np.integer):
        return Interval(int(arr.min()), int(arr.max()))
    return Interval(int(math.floor(float(arr.min()))), int(math.ceil(float(arr.max()))))


def _scalar_interval(v) -> Interval:
    if isinstance(v, bool):
        return Interval(int(v), int(v))
    if isinstance(v, int):
        return Interval(v, v)
    return Interval(int(math.floor(v)), int(math.ceil(v)))


# shape and copy operators: the value passes through element-wise
_PASSTHROUGH = {
    "view", "_unsafe_view", "reshape", "unsqueeze", "squeeze", "expand", "permute",
    "transpose", "t", "clone", "contiguous", "alias", "detach", "select", "slice",
    "flatten", "repeat", "_to_copy", "to", "lift_fresh_copy", "index", "index_select",
    "gather", "take", "embedding", "narrow", "flip", "roll", "as_strided",
}
# ...of which these keep a declared SumBound relation's origin
_ORIGIN_PRESERVING = _PASSTHROUGH - {"index", "index_select", "gather", "take", "embedding"}
_PREDICATES = {"eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isnan", "isinf",
               "logical_and", "logical_or", "logical_not", "logical_xor", "all", "any"}


def _reduced_extent(node: torch.fx.Node) -> int:
    """Elements summed into each output element: the input's element count
    over the output's, from the fake values."""
    src = node.args[0].meta["val"]
    out = node.meta["val"]
    return max(src.numel() // max(out.numel(), 1), 1)


def _transfer(node: torch.fx.Node, name: str, ivs: List[Optional[Interval]]) -> Interval:
    out_dtype = node.meta["val"].dtype
    a = ivs[0] if ivs else None
    b = ivs[1] if len(ivs) > 1 else None
    kw = node.kwargs
    full = _dtype_interval(out_dtype)

    if out_dtype == torch.bool or name in _PREDICATES:
        return Interval(0, 1)
    if name in ("add", "sub") and a is not None and b is not None:
        alpha = kw.get("alpha", 1)
        b = _mul_iv(b, _scalar_interval(alpha)) if alpha != 1 else b
        if name == "add":
            return Interval(a.lo + b.lo, a.hi + b.hi)
        return Interval(a.lo - b.hi, a.hi - b.lo)
    if name == "mul":
        return _mul_iv(a, b)
    if name in ("div", "floor_divide") and not out_dtype.is_floating_point:
        mode = "floor" if name == "floor_divide" else kw.get("rounding_mode")
        op = (lambda n, d: n // d) if mode == "floor" else _tdiv
        return _div_candidates(a, b, op)
    if name in ("remainder", "fmod"):
        m = max(abs(b.lo), abs(b.hi), 1) - 1
        return Interval(max(a.lo, -m), min(a.hi, m))
    if name == "neg":
        return Interval(-a.hi, -a.lo)
    if name == "abs":
        return Interval(0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi)), a.magnitude)
    if name == "sign":
        return Interval(-1 if a.lo < 0 else 0, 1 if a.hi > 0 else 0)
    if name in ("maximum", "clamp_min"):
        return Interval(max(a.lo, b.lo), max(a.hi, b.hi))
    if name in ("minimum", "clamp_max"):
        return Interval(min(a.lo, b.lo), min(a.hi, b.hi))
    if name == "clamp":
        lo_v = kw.get("min", node.args[1] if len(node.args) > 1 else None)
        hi_v = kw.get("max", node.args[2] if len(node.args) > 2 else None)
        lo, hi = a.lo, a.hi
        if lo_v is not None:
            lo, hi = max(lo, math.floor(lo_v)), max(hi, math.floor(lo_v))
        if hi_v is not None:
            lo, hi = min(lo, math.ceil(hi_v)), min(hi, math.ceil(hi_v))
        return Interval(lo, hi)
    if name == "bitwise_right_shift":
        return _shift(a, b, left=False)
    if name == "bitwise_left_shift":
        return _shift(a, b, left=True)
    if name == "bitwise_and":
        if a.lo >= 0 and b.lo >= 0:  # AND of non-negatives shrinks
            return Interval(0, min(a.hi, b.hi), a.words or b.words)
        return full
    if name in ("bitwise_or", "bitwise_xor"):
        if a.lo >= 0 and b.lo >= 0:
            return Interval(0, (1 << max(a.hi, b.hi).bit_length()) - 1, a.words or b.words)
        return full
    if name == "where":  # (cond, x, y)
        return ivs[1].hull(ivs[2])
    if name == "sum":
        return _sum_interval(a, _reduced_extent(node))
    if name in ("mm", "bmm", "matmul", "dot", "mv"):
        k = int(node.args[0].meta["val"].shape[-1])
        return _sum_interval(_mul_iv(a, b), max(k, 1))
    if name in ("amax", "amin", "max", "min"):
        return a
    if name in ("argmax", "argmin"):
        src = node.args[0].meta["val"]
        return Interval(0, max(max(src.shape, default=1) - 1, 0))
    if name in ("cat", "stack"):
        out = ivs[0]
        for other in ivs[1:]:
            out = out.hull(other)
        return out
    if name in ("full", "full_like", "fill", "scalar_tensor"):
        v = node.args[-1] if name != "full" else node.args[1]
        return _scalar_interval(v)
    if name in ("ones", "ones_like"):
        return Interval(1, 1)
    if name in ("zeros", "zeros_like", "new_zeros"):
        return Interval(0, 0)
    if name == "arange":
        n = int(node.meta["val"].numel())
        nums = [v for v in node.args if isinstance(v, (int, float))]
        start = int(nums[0]) if len(nums) > 1 else 0
        return Interval(min(start, start + n - 1), max(start, start + n - 1))
    if name in _PASSTHROUGH and a is not None:
        return a
    return full  # conservative default: sound, may alarm


# --------------------------------------------------------------------------
# the interpreter
# --------------------------------------------------------------------------

def analyze_intervals(
    gm: torch.fx.GraphModule,
    input_ranges: List[Interval],
    relations: Tuple[SumBound, ...] = (),
) -> IntervalReport:
    """Propagate integer intervals through the traced graph ``gm``.

    ``input_ranges`` gives one declared interval per graph input, in
    placeholder order (the analysis contract: the proof holds for every
    input inside its range); ``relations`` adds :class:`SumBound` facts
    between inputs, applied at division sites by dataflow-origin tracking.
    Nodes whose mathematical result range exceeds their output dtype are
    marked ``overflows``; the range is then clipped to the dtype so one
    overflow does not cascade.
    """
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(input_ranges) != len(placeholders):
        raise ValueError(f"got {len(input_ranges)} input ranges for "
                         f"{len(placeholders)} graph inputs")
    env: Dict[torch.fx.Node, object] = {}
    origins: Dict[torch.fx.Node, int] = {}
    report = IntervalReport(bounds=[], inputs=[])
    ctx = {(r.numerator, r.denominator): r.term_bound for r in relations}

    for i, (node, iv) in enumerate(zip(placeholders, input_ranges)):
        name = _dname(node.meta["val"].dtype, iv)
        over = _is_int_dtype(name) and not _fits(iv, name)
        report.inputs.append(EqnBound("input", name, iv, iv.signed_bits, over))
        env[node] = _clip(iv, name) if over else iv
        origins[node] = i

    def read(v) -> Optional[Interval]:
        if isinstance(v, torch.fx.Node):
            x = env.get(v)
            return x if isinstance(x, Interval) else None
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return _scalar_interval(v)
        if isinstance(v, (list, tuple)) and v and all(isinstance(x, torch.fx.Node) for x in v):
            parts = [read(x) for x in v]
            if all(p is not None for p in parts):
                out = parts[0]
                for p in parts[1:]:
                    out = out.hull(p)
                return out
        return None

    def origin(v) -> Optional[int]:
        return origins.get(v) if isinstance(v, torch.fx.Node) else None

    for node in gm.graph.nodes:
        if node.op == "get_attr":
            c = getattr(gm, node.target, None)
            if isinstance(c, torch.Tensor):
                env[node] = _const_interval(c)
            continue
        if node.op != "call_function":
            continue
        val = node.meta.get("val")
        if node.target is operator.getitem:
            parts = env.get(node.args[0])
            if isinstance(parts, list):
                env[node] = parts[node.args[1]]
            continue
        if not isinstance(val, torch.Tensor):  # multi-output or opaque: dtype ranges
            leaves = [t for t in (val if isinstance(val, (tuple, list)) else ())
                      if isinstance(t, torch.Tensor)]
            env[node] = [_dtype_interval(t.dtype) for t in leaves]
            for t, iv in zip(leaves, env[node]):
                report.bounds.append(EqnBound(op_name(node), _dname(t.dtype, iv), iv,
                                              iv.signed_bits, False))
            continue

        prim = op_name(node)
        name = prim.split(".")[0]
        ivs = [read(a) for a in node.args]
        if name == "index":  # index(table, [idx]): the table's range
            ivs = ivs[:1]
        if name in ("cat", "stack"):
            ivs = [read(x) for x in node.args[0]]

        iv = None
        # SumBound: n // d with n the declared running sum and d >= 1 derived
        # from the declared count: |sum of c terms| <= c*T => |n // c| <= T
        if (name in ("div", "floor_divide") and len(node.args) == 2
                and ivs[1] is not None and ivs[1].lo >= 1):
            t = ctx.get((origin(node.args[0]), origin(node.args[1])))
            if t is not None:
                iv = Interval(-t, t)
        if iv is None:
            operands = node.args[0] if name in ("cat", "stack") else node.args[:len(ivs)]
            unknown = any(isinstance(a, torch.fx.Node) and read(a) is None for a in operands)
            iv = _dtype_interval(val.dtype) if unknown else _transfer(node, name, ivs)
        dname = _dname(val.dtype, iv)
        over = _is_int_dtype(dname) and not _fits(iv, dname)
        report.bounds.append(EqnBound(prim, dname, iv, iv.signed_bits, over))
        env[node] = _clip(iv, dname) if over else iv

        # origin propagation: value-preserving single-input ops, and
        # max/min against an operand of no origin (the max(count, 1) guard)
        o: Optional[int] = None
        if name in _ORIGIN_PRESERVING and node.args:
            o = origin(node.args[0])
        elif name in ("maximum", "minimum", "clamp_min", "clamp_max", "clamp"):
            live = [origin(x) for x in node.args if isinstance(x, torch.fx.Node)]
            live = [x for x in live if x is not None]
            if len(live) == 1:
                o = live[0]
        if o is not None:
            origins[node] = o
    return report


# --------------------------------------------------------------------------
# the Eq. 39 overflow proof over a lowered score program
# --------------------------------------------------------------------------

def score_input_ranges(plan, tables, rules, horizon: int
                       ) -> Tuple[List[Interval], Tuple[SumBound, ...]]:
    """The declared input contract of the lowered score graph, in the flat
    order :func:`repro_torch.compile.int_lowering.score_graph` traces its
    inputs: ``(tables, rules, hidden_sum, count, sig, sticky)``.

    Tables and rules are concrete compiled tensors: their exact min and max
    (rule words read unsigned).  ``hidden_sum`` gets the Eq. 39 accumulator
    bound — ``horizon`` tokens of the worst-case quantized feature — which
    is the contract the serving engine keeps; ``count`` is [0, horizon];
    signatures span every 32-bit word.  The returned :class:`SumBound`
    states that ``hidden_sum`` is a sum of ``count`` per-token features.
    """
    from repro_torch.compile.int_lowering import score_graph_inputs
    from repro_torch.core.symbolic import words_u32

    per_tok = min(
        2 ** (plan.feature_bits - 1) - 1,
        int(math.floor(plan.feature_range * 2.0 ** plan.feature_frac + 0.5)),
    )
    acc = horizon * per_tok
    word_leaves = {id(rules.values), id(rules.masks)}
    ranges = []
    for leaf in score_graph_inputs(tables, rules):
        if id(leaf) in word_leaves:
            w = words_u32(leaf)
            ranges.append(Interval(int(w.min()), int(w.max()), words=True) if w.size
                          else Interval(0, 0, words=True))
        else:
            ranges.append(_const_interval(leaf))
    hidden_idx = len(ranges)
    ranges.append(Interval(-acc, acc))  # hidden_sum
    ranges.append(Interval(0, horizon))  # count
    ranges.append(WORD)  # sig
    ranges.append(Interval(0, 1))  # sticky
    return ranges, (SumBound(hidden_idx, hidden_idx + 1, per_tok),)


def prove_no_overflow(
    plan,
    tables,
    rules,
    *,
    horizon: Optional[int] = None,
    batch: int = 4,
    d_model: Optional[int] = None,
    ledger_entries=None,
) -> IntervalReport:
    """Statically prove the lowered score program cannot overflow int32 at
    the declared Eq. 39 horizon.

    Traces the plain score stage on fake tensors (:func:`~repro_torch
    .compile.int_lowering.score_graph`; nothing executes), seeds the
    interval interpreter with the Eq. 39 input contract and checks every
    integer node against its dtype.  On any provable overflow — an input
    whose declared range already exceeds its word included, which is how an
    overflow-unsafe horizon shows — raises :class:`AnalysisError` carrying
    the report.

    ``ledger_entries``: the ``int-lowering`` rows to cross-check.  The
    machine-derived max width must not exceed the widest hand-derived
    ``*-bits`` claim; if it does, the closed-form algebra under-claimed and
    this raises :class:`AnalysisError` too.
    """
    from repro_torch.compile.int_lowering import score_graph

    horizon = horizon if horizon is not None else plan.horizon
    d = d_model if d_model is not None else int(tables["cls_w"].shape[0])
    gm = score_graph(plan, tables, rules, batch, d)
    ranges, relations = score_input_ranges(plan, tables, rules, horizon)
    report = analyze_intervals(gm, ranges, relations)
    bad = report.overflows()
    if bad:
        rows = "; ".join(f"{b.primitive}[{b.dtype}] needs {b.signed_bits} bits "
                         f"(range {b.interval})" for b in bad[:4])
        raise AnalysisError(f"interval analysis proves int32 overflow is reachable at "
                            f"horizon={horizon}: {rows}", report=report)
    if ledger_entries is not None:
        hand = [e for e in ledger_entries
                if e.stage == "int-lowering" and e.resource.endswith("-bits")
                and e.resource != "feature-frac-bits"]
        if hand:
            claimed = max(int(e.used) for e in hand)
            if report.max_signed_bits > claimed:
                raise AnalysisError(
                    f"hand-derived ledger widths under-claim: closed-form max is "
                    f"{claimed} bits but the interval proof needs "
                    f"{report.max_signed_bits} bits", report=report)
    return report
