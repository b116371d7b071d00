"""Pluggable audit framework over traced aten graphs (the port's counterpart
of ``repro.analysis.jaxpr_lint``; it walks ``torch.fx`` graphs where the JAX
package walks jaxprs, hence the name).

A function is traced with ``make_fx(fn, tracing_mode="fake")``
(:func:`trace_graph`): fake tensors carry shapes and dtypes and nothing
executes, which is what ``jax.make_jaxpr`` does for the JAX package.  Every
node of the resulting graph is one aten operator, with its output's fake
value in ``node.meta["val"]``.  The checks share one recursive walk:

* :class:`FloatOpCheck` — a floating-point operand, result, tensor
  constant or Python float argument (a **literal**) anywhere in an
  integer-lowered path.
* :class:`HostSyncCheck` — the counterpart of host callbacks: an operator
  that makes the host wait for the card inside the hot path.  A value read
  on the host (``aten._local_scalar_dense``, from ``.item()`` or
  ``bool()``), a copy to a CPU device, and an operator whose output shape
  depends on the data (``nonzero``, ``masked_select``, ``unique``: the
  operator tags ``data_dependent_output`` and ``dynamic_output_shape``).  A
  trace that stops for want of a concrete value (a Python branch on a
  tensor) is the same hazard: :func:`trace_failure` turns it into a finding.
* :class:`PromotionCheck` — the counterpart of weak-type hazards: a Python
  scalar, or a default-dtype (int64, float64) tensor, that widens an int32
  or float32 path (``int32 * 0.5`` is float32; an int32 ``sum`` without
  ``dtype=`` is int64).
* :func:`donation_safety` — the donated-argument contract of an entry point,
  at the JAX package's shape-and-dtype rule, with the outputs' shapes from
  fake tensors.

The walker recurses into the subgraphs of ``torch.ops.higher_order``
operators (``cond`` branches, ``while_loop`` bodies, ``map``), which a
traced graph holds as submodules reached through ``get_attr`` nodes, however
deeply the operator's arguments nest them.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode
from torch.utils import _pytree as pytree
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensorMode,
)

# a trace that raises one of these stopped for want of a concrete value
DATA_DEPENDENT = (GuardOnDataDependentSymNode, DataDependentOutputException,
                  DynamicOutputShapeException)
# tensor dtypes a bare Python number or a default-constructed tensor takes
DEFAULT_DTYPES = (torch.int64, torch.float64)
# operators whose job is to change a dtype: never a promotion hazard
CONVERSIONS = ("_to_copy", "to", "convert_element_type", "type_as", "copy", "copy_",
               "_local_scalar_dense")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit: which check fired, where, and why."""

    check: str  # check name, e.g. "float-ops"
    primitive: str  # operator whose node triggered the finding
    message: str  # human-readable context (dtype, operand kind, path)
    path: str = ""  # nesting path, e.g. "cond/while_loop"

    def __str__(self) -> str:
        where = f" at {self.path}" if self.path else ""
        return f"[{self.check}] {self.primitive}{where}: {self.message}"


def trace_graph(fn: Callable, *args) -> torch.fx.GraphModule:
    """``fn`` traced on fake tensors of ``args``' shapes and dtypes (nothing
    executes).  ``args`` is a pytree of tensors (nested tuples, lists and
    dicts).  Tensors that ``fn`` closes over become the graph's constants
    (``get_attr`` nodes), as closed-over arrays become a jaxpr's constvars.
    Raises one of :data:`DATA_DEPENDENT` when the trace needs a concrete
    value."""
    return make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)


def trace_failure(exc: BaseException) -> Finding:
    """The host-sync finding of a trace that stopped for want of a value."""
    first = str(exc).strip().splitlines()[0] if str(exc).strip() else ""
    return Finding("host-sync", type(exc).__name__,
                   f"the trace needs a concrete tensor value on the host: {first[:160]}")


# --------------------------------------------------------------------------
# the walker
# --------------------------------------------------------------------------

def op_name(node: torch.fx.Node) -> str:
    """``"mul.Tensor"`` for an aten overload, ``"cond"`` for a higher-order
    operator, the node's op kind otherwise."""
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t.__name__
    if isinstance(t, torch._ops.HigherOrderOperator):
        return t.name()
    return getattr(t, "__name__", str(t))


def _nodes_in(value) -> Iterable[torch.fx.Node]:
    """Every fx Node inside an argument, through nested tuples, lists and dicts."""
    if isinstance(value, torch.fx.Node):
        yield value
    elif isinstance(value, (tuple, list)):
        for item in value:
            yield from _nodes_in(item)
    elif isinstance(value, dict):
        for item in value.values():
            yield from _nodes_in(item)


def _subgraphs(gm: torch.nn.Module, node: torch.fx.Node) -> Iterable[torch.fx.GraphModule]:
    """The subgraph modules a higher-order operator's node reads."""
    if node.op != "call_function" or not isinstance(node.target, torch._ops.HigherOrderOperator):
        return
    for arg in _nodes_in((node.args, node.kwargs)):
        if arg.op == "get_attr":
            sub = getattr(gm, arg.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                yield sub


def walk_graph(gm, visit: Callable, path: str = "") -> None:
    """Apply ``visit(node, path, module)`` to every node of ``gm``'s graph and
    of every subgraph its higher-order operators read, however deeply their
    arguments nest them.  ``path`` accumulates the operator nesting
    (``"cond/while_loop"``); ``module`` is the graph module that owns the
    node (its ``get_attr`` targets live there)."""
    graph = gm.graph if hasattr(gm, "graph") else gm
    for node in graph.nodes:
        visit(node, path, gm)
        sub_path = f"{path}/{op_name(node)}" if path else op_name(node)
        for sub in _subgraphs(gm, node):
            walk_graph(sub, visit, sub_path)


def _vals(x) -> List[torch.Tensor]:
    """The tensors of a node's fake value (a tensor, or a tuple of them)."""
    return [t for t in pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _operand_tensors(node: torch.fx.Node, gm) -> List[Tuple[str, torch.Tensor]]:
    """(kind, value) of each tensor operand: "operand" for a graph value,
    "constvar" for a tensor constant the graph holds."""
    out = []
    for arg in _nodes_in((node.args, node.kwargs)):
        if arg.op == "get_attr":
            c = getattr(gm, arg.target, None)
            if isinstance(c, torch.Tensor):
                out.append(("constvar", c))
            continue
        for t in _vals(arg.meta.get("val")):
            out.append(("operand", t))
    return out


def _scalars(node: torch.fx.Node) -> List[object]:
    """The Python numbers among a node's arguments (nested lists included)."""
    out = []

    def visit(v):
        if isinstance(v, bool):
            return
        if isinstance(v, (int, float)):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            for x in v:
                visit(x)

    for a in list(node.args) + list(node.kwargs.values()):
        visit(a)
    return out


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _is_op(node: torch.fx.Node) -> bool:
    """An operator node worth auditing (not the tuple unpacking of a result)."""
    return node.op == "call_function" and node.target is not operator.getitem


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

class LintCheck:
    """One pluggable audit: ``on_node`` sees every node (with its nesting
    path and owning module), ``finish`` returns the accumulated findings."""

    name = "lint-check"

    def on_node(self, node, path: str, gm) -> None:  # pragma: no cover - interface
        pass

    def finish(self) -> List[Finding]:  # pragma: no cover - interface
        return []


class FloatOpCheck(LintCheck):
    """No floating-point dtype may appear in the audited graph: not as an
    operand, a result, a tensor constant (``constvar``), or a Python float
    argument (``literal``).  A graph input that no operator reads (the
    float rule weights beside the integer table) is not an operation."""

    name = "float-ops"

    def __init__(self):
        self.findings: List[Finding] = []

    def on_node(self, node, path: str, gm) -> None:
        if not _is_op(node):
            return
        prim = op_name(node)
        seen = set()

        def flag(kind, dtype):
            if (kind, dtype) not in seen:
                seen.add((kind, dtype))
                self.findings.append(Finding(self.name, prim, f"{kind}[{dtype}]", path))

        for kind, t in _operand_tensors(node, gm):
            if t.is_floating_point() or t.is_complex():
                flag(kind, _dt(t.dtype))
        for s in _scalars(node):
            if isinstance(s, float):
                flag("literal", "float")
        for t in _vals(node.meta.get("val")):
            if t.is_floating_point() or t.is_complex():
                flag("result", _dt(t.dtype))

    def finish(self) -> List[Finding]:
        return self.findings


class HostSyncCheck(LintCheck):
    """Operators that make the host wait for the card: a value read on the
    host, a copy to a CPU device, an output shape that depends on the data.
    Each stalls the stream once per launch — correct, never line rate."""

    name = "host-sync"

    def __init__(self):
        self.findings: List[Finding] = []

    def on_node(self, node, path: str, gm) -> None:
        if not _is_op(node):
            return
        t = node.target
        tags = getattr(t, "tags", ())
        why = None
        if torch.Tag.data_dependent_output in tags:
            why = "reads a tensor value on the host"
        elif torch.Tag.dynamic_output_shape in tags:
            why = "output shape depends on the data (the host waits for it)"
        else:
            outs = _vals(node.meta.get("val"))
            ins = [v for k, v in _operand_tensors(node, gm) if k == "operand"]
            if (outs and all(o.device.type == "cpu" for o in outs)
                    and any(i.device.type != "cpu" for i in ins)):
                why = f"copies from {ins[0].device.type} to the host"
        if why:
            self.findings.append(Finding(self.name, op_name(node), why, path))

    def finish(self) -> List[Finding]:
        return self.findings


class PromotionCheck(LintCheck):
    """A Python scalar or a default-dtype (int64, float64) tensor operand
    that widens an int32 or float32 path: the node's result is wider than
    its other tensor operands' common dtype (float where they are integer,
    or more bytes).  Conversions (``_to_copy``) and predicates (a bool
    result) are exempt: their dtype is asked for."""

    name = "dtype-promotion"

    def __init__(self):
        self.findings: List[Finding] = []

    def on_node(self, node, path: str, gm) -> None:
        if not _is_op(node) or isinstance(node.target, torch._ops.HigherOrderOperator):
            return
        prim = op_name(node)
        if prim.split(".")[0] in CONVERSIONS:
            return
        outs = _vals(node.meta.get("val"))
        if len(outs) != 1 or outs[0].dtype == torch.bool:
            return
        tensors = [t for _, t in _operand_tensors(node, gm)]
        narrow = [t.dtype for t in tensors if t.dtype not in DEFAULT_DTYPES
                  and t.dtype != torch.bool and t.dim() > 0]
        if not narrow:
            return
        want = narrow[0]
        for dt in narrow[1:]:
            want = torch.promote_types(want, dt)
        got = outs[0].dtype
        widened = ((got.is_floating_point and not want.is_floating_point)
                   or (got.is_floating_point == want.is_floating_point
                       and got.itemsize > want.itemsize))
        if not widened:
            return
        causes = [f"python float {s!r}" for s in _scalars(node) if isinstance(s, float)]
        causes +=[f"{_dt(t.dtype)} tensor" for t in tensors if t.dtype in DEFAULT_DTYPES]
        cause = ", ".join(causes[:2]) if causes else "the operator's default result dtype"
        self.findings.append(Finding(
            self.name, prim, f"{_dt(want)} path widens to {_dt(got)} ({cause})", path))

    def finish(self) -> List[Finding]:
        return self.findings


# --------------------------------------------------------------------------
# the linter
# --------------------------------------------------------------------------

class GraphLinter:
    """Run a set of :class:`LintCheck` instances over one graph in one walk."""

    def __init__(self, checks: Sequence[LintCheck]):
        self.checks = list(checks)

    def lint(self, gm) -> List[Finding]:
        def visit(node, path, owner):
            for c in self.checks:
                c.on_node(node, path, owner)

        walk_graph(gm, visit)
        out: List[Finding] = []
        for c in self.checks:
            out.extend(c.finish())
        return out


def default_linter(*, int_path: bool = True) -> GraphLinter:
    """The standard battery: host syncs and promotion hazards always; float
    ops only for integer-lowered paths."""
    checks: List[LintCheck] = [HostSyncCheck(), PromotionCheck()]
    if int_path:
        checks.insert(0, FloatOpCheck())
    return GraphLinter(checks)


def lint_graph(gm, *, int_path: bool = True) -> List[Finding]:
    return default_linter(int_path=int_path).lint(gm)


def float_ops_in_graph(gm) -> List[str]:
    """Labels of every floating-point operand, result, literal and constant
    of the (recursively walked) graph, in the JAX package's label format:
    ``op[dtype]``, ``op[dtype] literal``, ``constvar[dtype]``."""
    out: List[str] = []
    for f in GraphLinter([FloatOpCheck()]).lint(gm):
        kind, dtype = f.message.split("[", 1)
        dtype = dtype.rstrip("]")
        if kind == "constvar":
            out.append(f"constvar[{dtype}]")
        elif kind == "literal":
            out.append(f"{f.primitive}[{dtype}] literal")
        else:
            out.append(f"{f.primitive}[{dtype}]")
    return out


def host_syncs_in_graph(gm) -> List[Finding]:
    return GraphLinter([HostSyncCheck()]).lint(gm)


def promotion_hazards(gm) -> List[Finding]:
    return GraphLinter([PromotionCheck()]).lint(gm)


# --------------------------------------------------------------------------
# donation safety (entry-point level)
# --------------------------------------------------------------------------

def _leaf_key(t: torch.Tensor) -> Tuple[Tuple[int, ...], str]:
    return tuple(int(s) for s in t.shape), _dt(t.dtype)


def donation_safety(
    fn: Callable,
    args: Tuple,
    donate_argnums: Tuple[int, ...],
    kwargs: Optional[dict] = None,
) -> List[Finding]:
    """Audit an entry point's donation contract without executing it.

    ``args`` are tensors (real or on the ``meta`` device; only shapes and
    dtypes are read) in pytrees; ``fn`` runs on fake tensors of the same
    shapes and dtypes.  Per donated argnum: every donated leaf must be able
    to alias some output leaf of the same shape and dtype (a donation no
    output can take is a buffer freed for nothing), no shape and dtype may
    be donated more times than outputs absorb, and a donated leaf must be a
    tensor.
    """
    kwargs = kwargs or {}
    findings: List[Finding] = []
    mode = FakeTensorMode()

    def fake(x):
        if not isinstance(x, torch.Tensor):
            return x
        with mode:
            return torch.empty(tuple(x.shape), dtype=x.dtype, device="cpu")

    with mode:
        out = fn(*pytree.tree_map(fake, tuple(args)), **pytree.tree_map(fake, kwargs))
    pool: dict = {}
    for leaf in pytree.tree_leaves(out):
        if isinstance(leaf, torch.Tensor):
            key = _leaf_key(leaf)
            pool[key] = pool.get(key, 0) + 1

    for argnum in donate_argnums:
        if argnum >= len(args):
            findings.append(Finding("donation", "entry",
                                    f"donate_argnums={argnum} beyond positional arity "
                                    f"{len(args)}"))
            continue
        for leaf in pytree.tree_leaves(args[argnum]):
            if not isinstance(leaf, torch.Tensor):
                findings.append(Finding("donation", "entry",
                                        f"argnum {argnum} donates a non-array leaf "
                                        f"({type(leaf).__name__})"))
                continue
            key = _leaf_key(leaf)
            if pool.get(key, 0) > 0:
                pool[key] -= 1
            else:
                findings.append(Finding(
                    "donation", "entry",
                    f"argnum {argnum} donates {key[1]}{list(key[0])} but no remaining "
                    f"output can alias it (unused donation → silent copy)",
                ))
    return findings
