"""Versioned, atomic checkpoints in the JAX package's on-disk layout (port
of ``repro.checkpoint.checkpointer``), written and read with numpy::

    <dir>/step_<N>.tmp/...      (in-flight write)
    <dir>/step_<N>/
        manifest.json           (leaf names, shapes, dtypes, step, extra)
        arrays.npz              (leaves a0, a1, ... in flatten order)

The tmp directory is renamed into place only after every array and the
manifest are written and the manifest fsync'd, so a crashed writer never
leaves a half checkpoint.  Saves may run on a writer thread; ``keep``
bounds the steps kept.

A tree is nested dicts whose leaves are tensors or arrays, with a RuleSet
(anything with ``tensors()``) or a decode state (``leaves()``) as a node
flattened by position, as JAX flattens its registered nodes.  Leaves go
out in JAX's flatten order (sorted dict keys; a RuleSet as values, masks,
weights, hard; a decode state as S, Z, k_buf, v_buf, count) under JAX's
``keystr`` names (``['params']['cls']['w']``, ``['rules'][<flat index
0>]``), so JAX's positional ``restore`` reads what this writes.
:meth:`Checkpointer.restore` reads by those names into nested dicts of
numpy arrays (a positional node's leaves under the keys 0, 1, ...), or,
given a target tree of nested dicts of tensors, into that tree's
structure: each leaf on the target leaf's device in its dtype, as the JAX
package's ``restore(target_tree)`` reads a checkpoint positionally into
its target.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_with_names(tree: Any, prefix: str = "") -> Tuple[List[str], List[Any]]:
    """``(names, leaves)`` in JAX's flatten order, named as ``keystr`` names them."""
    if isinstance(tree, dict):
        names, leaves = [], []
        for k in sorted(tree):
            n, lv = flatten_with_names(tree[k], f"{prefix}[{k!r}]")
            names += n
            leaves += lv
        return names, leaves
    if hasattr(tree, "tensors") or hasattr(tree, "leaves"):  # nodes flattened by position
        ts = tree.tensors() if hasattr(tree, "tensors") else tree.leaves()
        return [f"{prefix}[<flat index {i}>]" for i in range(len(ts))], list(ts)
    return [prefix], [tree]


_KEY = re.compile(r"\[(?:'([^']*)'|<flat index (\d+)>)\]")


def _path(name: str) -> List[Any]:
    """The keys of a ``keystr`` name: strings, or ints for flat indices."""
    keys, pos = [], 0
    for m in _KEY.finditer(name):
        if m.start() != pos:
            raise ValueError(f"checkpoint leaf name {name!r} is not a dict/index path")
        keys.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(name) or not keys:
        raise ValueError(f"checkpoint leaf name {name!r} is not a dict/index path")
    return keys


def unflatten_names(names: List[str], leaves: List[Any]) -> Dict:
    """Nested dicts from ``keystr`` names (the inverse of
    :func:`flatten_with_names`, with a flat-indexed node as a dict of ints)."""
    root: Dict = {}
    for name, leaf in zip(names, leaves):
        *head, last = _path(name)
        node = root
        for k in head:
            node = node.setdefault(k, {})
        if last in node:
            raise ValueError(f"checkpoint leaf {name!r} appears twice")
        node[last] = leaf
    return root


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Copy the leaves to the host, then write (on a thread unless blocking)."""
        self.wait()
        names, leaves = flatten_with_names(tree)
        host = [_host(x) for x in leaves]

        def write():
            try:
                self._write(step, names, host, extra or {})
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, names, host_leaves, extra: Dict) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": x for i, x in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "names": names,
            "shapes": [list(x.shape) for x in host_leaves],
            "dtypes": [str(x.dtype) for x in host_leaves],
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with open(os.path.join(self.directory, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f)

    def restore(self, target_tree: Any = None,
                step: Optional[int] = None) -> Tuple[Any, Dict, int]:
        """``(tree, extra, step)`` of a step (the latest by default).

        Without ``target_tree``: the leaves as numpy arrays in nested dicts
        rebuilt from the manifest's names.  With one: the target's
        structure (nested dicts of tensors), each leaf placed on the target
        leaf's device in its dtype; raises if the number of leaves, a name
        or a shape differs."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        manifest = self.manifest(step)
        final = os.path.join(self.directory, f"step_{step:08d}")
        with np.load(os.path.join(final, "arrays.npz")) as data:
            leaves = [data[f"a{i}"] for i in range(len(manifest["names"]))]
        for name, leaf, shape, dtype in zip(manifest["names"], leaves, manifest["shapes"],
                                            manifest["dtypes"]):
            if list(leaf.shape) != shape or str(leaf.dtype) != dtype:
                raise ValueError(f"checkpoint leaf {name}: {leaf.shape}/{leaf.dtype} against "
                                 f"the manifest's {shape}/{dtype}")
        if target_tree is None:
            return unflatten_names(manifest["names"], leaves), manifest["extra"], step
        names, targets = flatten_with_names(target_tree)
        if len(targets) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, target {len(targets)}")
        placed = []
        for name, saved, leaf, target in zip(manifest["names"], names, leaves, targets):
            if name != saved or tuple(leaf.shape) != tuple(target.shape):
                raise ValueError(f"checkpoint leaf {name} {tuple(leaf.shape)} against the "
                                 f"target's {saved} {tuple(target.shape)}")
            placed.append(_like(leaf, target))
        return _rebuild(target_tree, iter(placed)), manifest["extra"], step


def _like(leaf: np.ndarray, target):
    """``leaf`` as a tensor on ``target``'s device in its dtype."""
    import torch

    return torch.from_numpy(np.array(leaf)).to(device=target.device, dtype=target.dtype)


def _rebuild(tree: Any, leaves) -> Any:
    """``tree``'s structure (nested dicts of tensors) with its leaves taken
    in order from ``leaves`` (the order of :func:`flatten_with_names`)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if not hasattr(tree, "detach"):
        raise TypeError(f"restore: a target leaf of type {type(tree).__name__}; a target "
                        f"tree is nested dicts of tensors")
    return next(leaves)
