"""Flat-buffer layout for the fused mixing round.

The port of ``repro/dist/flat.py``.  :class:`FlatSpec` freezes a
parameter tree's layout so each client's whole model lives in **one
contiguous lane-padded row**: ``ravel`` turns a tree of ``(B, ...)``
leaves into one ``(B, N)`` buffer and ``unravel`` gives the tree back.
The mixing round then runs on that buffer as one
:func:`repro_torch.kernels.gather_mix.gather_mix` launch.

The layout is the reference's, so the same tree gives the same row, bit
for bit:

* **Trees** are nested dicts (and lists / tuples) of tensors; dict keys
  are visited in sorted order, as ``jax.tree.flatten`` visits them.
* **Leading batch dim**: every leaf carries the same leading dim B.
  Leaf ``l`` occupies columns ``offsets[l] : offsets[l] + sizes[l]``.
* **Lane padding**: each leaf's segment is zero-padded up to a multiple
  of :data:`LANE` (128), so every offset is a multiple of 128 and so is
  N.  Pad columns are mixed like everything else (mixing is linear,
  zeros stay zeros) and dropped by ``unravel``.
* **Dtypes**: the buffer has one floating dtype (default f32) and the
  spec records each leaf's dtype; leaves that do not embed losslessly
  (non-float, or wider than the buffer) are rejected.

Unlike the reference, which returns new arrays, ``unravel`` and
``unravel_row`` return **views** into the buffer for every leaf of the
buffer's dtype (a cast copy for the others), so a step that updates the
tree in place updates the buffer; ``ravel`` can write into a given
buffer (``out=``) instead of allocating one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

#: The lane width of the reference's layout (``repro.kernels.weighted_mix.LANE``):
#: every leaf segment starts on a multiple of it.
LANE = 128


def _pad_to(n: int, lane: int) -> int:
    return -(-n // lane) * lane


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) with dict keys in sorted order, the order of
    ``jax.tree.flatten``.  The treedef is a hashable skeleton."""
    if isinstance(tree, dict):
        leaves, subs = [], []
        for k in sorted(tree):
            sub_leaves, sub = tree_flatten(tree[k])
            leaves += sub_leaves
            subs.append((k, sub))
        return leaves, ("dict", tuple(subs))
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for item in tree:
            sub_leaves, sub = tree_flatten(item)
            leaves += sub_leaves
            subs.append(sub)
        return leaves, (type(tree).__name__, tuple(subs))
    return [tree], None


def _build(node, it) -> Any:
    # a module-level recursion: a nested recursive closure would form a
    # reference cycle holding the leaves until the garbage collector ran
    if node is None:
        return next(it)
    kind, subs = node
    if kind == "dict":
        return {k: _build(d, it) for k, d in subs}
    items = [_build(d, it) for d in subs]
    return items if kind == "list" else tuple(items)


def tree_unflatten(treedef, leaves) -> Any:
    """The inverse of :func:`tree_flatten`."""
    return _build(treedef, iter(leaves))


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    leaves, treedef = tree_flatten(trees[0])
    rest = [tree_flatten(t)[0] for t in trees[1:]]
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(leaves, *rest)])


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Frozen layout of one parameter tree inside a (B, N) flat buffer.
    Built with :meth:`for_tree`."""

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]     # per-leaf trailing shapes
    dtypes: Tuple[torch.dtype, ...]         # per-leaf original dtypes
    offsets: Tuple[int, ...]                # lane-aligned segment starts
    sizes: Tuple[int, ...]                  # unpadded element counts
    batch: int                              # the shared leading dim B
    size: int                               # N: total padded width
    dtype: torch.dtype                      # buffer dtype

    @classmethod
    def for_tree(cls, tree, dtype=torch.float32, lane: int = LANE) -> "FlatSpec":
        """Freeze the layout of ``tree`` (leaves shaped (B, ...))."""
        leaves, treedef = tree_flatten(tree)
        if not leaves:
            raise ValueError("cannot build a FlatSpec over an empty tree")
        if not dtype.is_floating_point:
            raise ValueError(f"buffer dtype must be floating, got {dtype}")
        bits = torch.finfo(dtype).bits
        batch = leaves[0].shape[0] if leaves[0].dim() else None
        shapes, dtypes, offsets, sizes = [], [], [], []
        off = 0
        for i, leaf in enumerate(leaves):
            shape = tuple(leaf.shape)
            if not shape or shape[0] != batch:
                raise ValueError(
                    f"leaf {i} shape {shape} does not carry the shared "
                    f"leading batch dim {batch}")
            dt = leaf.dtype
            if not dt.is_floating_point or torch.finfo(dt).bits > bits:
                raise ValueError(
                    f"leaf {i} dtype {dt} does not embed losslessly in "
                    f"the {dtype} buffer (floating, ≤ {bits} bits required)")
            size = math.prod(shape[1:])
            shapes.append(shape[1:])
            dtypes.append(dt)
            offsets.append(off)
            sizes.append(size)
            off += _pad_to(size, lane)
        return cls(treedef=treedef, shapes=tuple(shapes), dtypes=tuple(dtypes),
                   offsets=tuple(offsets), sizes=tuple(sizes), batch=batch,
                   size=off, dtype=dtype)

    def _leaves(self, tree) -> List[torch.Tensor]:
        leaves, treedef = tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure does not match the FlatSpec")
        return leaves

    def ravel(self, tree, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Tree of (B, ...) leaves → one contiguous (B, N) buffer, written
        into ``out`` when given (a leaf that already is a view of its own
        segment of ``out`` is not copied)."""
        leaves = self._leaves(tree)
        if out is None:
            out = torch.empty((self.batch, self.size), dtype=self.dtype,
                              device=leaves[0].device)
        elif tuple(out.shape) != (self.batch, self.size) or out.dtype != self.dtype:
            raise ValueError(
                f"buffer shape {tuple(out.shape)} {out.dtype} != "
                f"({self.batch}, {self.size}) {self.dtype}")
        for leaf, size, off, nxt in zip(leaves, self.sizes, self.offsets,
                                        self.offsets[1:] + (self.size,)):
            seg = out[:, off:off + size]
            if not (leaf.data_ptr() == seg.data_ptr() and leaf.dtype == seg.dtype):
                seg.copy_(leaf.reshape(self.batch, size))
            out[:, off + size:nxt].zero_()
        return out

    def unravel(self, buf: torch.Tensor):
        """(B, N) buffer → the original tree: views of ``buf`` for leaves
        of the buffer's dtype, cast copies for the others."""
        if tuple(buf.shape) != (self.batch, self.size):
            raise ValueError(
                f"buffer shape {tuple(buf.shape)} != ({self.batch}, {self.size})")
        return tree_unflatten(self.treedef, [
            buf[:, off:off + size].view((self.batch,) + shape).to(dt)
            for shape, dt, off, size in zip(self.shapes, self.dtypes,
                                            self.offsets, self.sizes)])

    def unravel_row(self, row: torch.Tensor):
        """One (N,) flat row → the per-client tree *without* the batch dim
        (leaf l gets shape ``shapes[l]``), as views of ``row`` where the
        dtypes match: the serving plane's hot model-reload seam, and the
        local step's parameters."""
        if tuple(row.shape) != (self.size,):
            raise ValueError(f"row shape {tuple(row.shape)} != ({self.size},)")
        return tree_unflatten(self.treedef, [
            row[off:off + size].view(shape).to(dt)
            for shape, dt, off, size in zip(self.shapes, self.dtypes,
                                            self.offsets, self.sizes)])
