"""Checkpointing: a tree of tensors → (npz arrays + json treedef) on disk.

The port of ``repro/ckpt/checkpoint.py``, in the reference's on-disk
format, so that a checkpoint written by either package loads in the
other, bit for bit:

* ``path + ".npz"`` holds the leaves, each under its path in the tree
  with ``|`` for ``/`` (dict keys by name in sorted order, list and
  tuple items as ``#i``);
* ``path + ".json"`` holds the treedef (dict, tuple and list kinds), each
  leaf's dtype string and the metadata;
* bfloat16 leaves are stored as ``uint16`` views under the dtype name
  ``"bfloat16"``.

Leaves may be tensors on any device (saved through the CPU) or numpy
arrays.  :func:`load` returns CPU tensors, ``"bfloat16"`` leaves as
``torch.bfloat16``.  :class:`CheckpointManager` keeps step-numbered
checkpoints with ``latest()`` discovery and retention.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten_with_paths(v, f"{prefix}/#{i}"))
        return out
    return [(prefix, tree)]


def _treedef(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict", "keys": {k: _treedef(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_treedef(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_treedef(v) for v in tree]}
    return {"__kind__": "leaf"}


def _rebuild(defn, leaves: Dict[str, torch.Tensor], prefix=""):
    kind = defn["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, leaves, f"{prefix}/{k}")
                for k, v in defn["keys"].items()}
    if kind in ("tuple", "list"):
        items = [_rebuild(v, leaves, f"{prefix}/#{i}")
                 for i, v in enumerate(defn["items"])]
        return tuple(items) if kind == "tuple" else items
    return leaves[prefix]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array to store, its dtype string): bfloat16 as a uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    """Write ``tree`` and ``metadata`` to ``path + ".npz"`` and
    ``path + ".json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for name, leaf in _flatten_with_paths(tree):
        arrays[name], dtypes[name] = _to_numpy(leaf)
    np.savez(path + ".npz", **{k.replace("/", "|"): v for k, v in arrays.items()})
    with open(path + ".json", "w") as f:
        json.dump({"treedef": _treedef(tree), "dtypes": dtypes,
                   "metadata": metadata or {}}, f)


def load(path: str) -> Tuple[Any, dict]:
    """(the tree with CPU tensor leaves, the metadata) of ``path``."""
    with open(path + ".json") as f:
        spec = json.load(f)
    with np.load(path + ".npz") as z:
        leaves = {}
        for k in z.files:
            name = k.replace("|", "/")
            arr = z[k]
            if spec["dtypes"][name] == "bfloat16":
                leaves[name] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                leaves[name] = torch.from_numpy(arr)
    return _rebuild(spec["treedef"], leaves), spec["metadata"]


class CheckpointManager:
    """Step-numbered checkpoints (``ckpt_00000012``) with retention: the
    newest ``keep`` are kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
        meta = dict(metadata or {})
        meta["step"] = step
        save(self._path(step), tree, meta)
        self._retain()
        return self._path(step)

    def steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.directory):
            m = re.match(r"ckpt_(\d+)\.json$", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int] = None) -> Tuple[Any, dict]:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load(self._path(step))

    def _retain(self) -> None:
        for s in self.steps()[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(self._path(s) + ext)
                except OSError:
                    pass


def state_leaves(state: dict) -> list:
    """The leaves of a training state ``{"params", "opt_state"[,
    "residual"]}`` in the order ``jax.tree.leaves`` gives the reference's
    state, which is the order of its checkpoints' leaf lists: the keys
    sorted (``opt_state``, ``params``, ``residual``), each subtree's dict
    keys sorted, and an AdamW state — the port's dict ``{"mu", "nu",
    "count"}`` — in the order of the reference's ``AdamWState(mu, nu,
    count)``: every leaf of ``mu``, every leaf of ``nu``, then ``count``
    (where :func:`repro_torch.dist.flat.tree_flatten`, which sorts the
    dict, would put ``count`` first).  The leaves are the state's own
    tensors, so a restore can copy into them in place."""
    from ..dist.flat import tree_flatten
    leaves = []
    for key in sorted(state):
        sub = state[key]
        if key == "opt_state" and isinstance(sub, dict) and \
                set(sub) == {"mu", "nu", "count"}:
            leaves += (tree_flatten(sub["mu"])[0] + tree_flatten(sub["nu"])[0]
                       + [sub["count"]])
        else:
            leaves += tree_flatten(sub)[0]
    return leaves
