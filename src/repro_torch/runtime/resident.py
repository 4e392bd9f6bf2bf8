"""The resident training state of a set of clients.

Both training drivers keep their clients' models as the rows of one
(rows, N) f32 flat buffer (:class:`repro_torch.dist.flat.FlatSpec`),
allocated once and updated in place: the slot runtime
(:class:`repro_torch.runtime.loop.SlotTrainLoop`, a row a slot) and the
front door (:mod:`repro_torch.launch.train`, a row for each of a rank's
G clients).  The local step sees a tree of views into the buffer; the
flat mixer writes the round into a second buffer, and the two swap
roles every round (:meth:`Resident.swap`), so a round allocates nothing
of N's size beyond one client's gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..dist.flat import FlatSpec, tree_flatten, tree_map


@dataclasses.dataclass
class Resident:
    """One set of clients' training state, resident for the whole run.

    ``params`` is the (rows, N) f32 buffer the models live in (``spec``
    its stacked layout, ``row_spec`` one row's); ``spare`` the buffer the
    flat mixer writes (None where no mixer writes one); ``opt_state``
    the (rows, ...)-stacked optimizer state; ``residual`` the (rows, N)
    f32 error-feedback residual (None without one); ``workspace`` the
    codec's wire buffers (None without a codec)."""

    spec: FlatSpec
    row_spec: FlatSpec
    params: torch.Tensor
    opt_state: Any
    spare: Optional[torch.Tensor] = None
    residual: Optional[torch.Tensor] = None
    workspace: Optional[dict] = None

    @classmethod
    def allocate(cls, row_tree, rows: int, optimizer, *, spare: bool, codec=None,
                 error_feedback: bool = False, device=None) -> "Resident":
        """Zeroed parameters for ``rows`` clients of ``row_tree``'s layout
        (one client's tree, read for its shapes), on ``device`` (default
        the tree's); every row's optimizer state as ``optimizer.init``
        gives it; with ``spare`` the mixer's output buffer, with a
        ``codec`` its workspace, with ``error_feedback`` a zeroed
        residual.  The rows are written with :meth:`write_row`."""
        first = tree_flatten(row_tree)[0][0]
        device = first.device if device is None else torch.device(device)
        # the stacked layout, read from shapes alone (expand is a view)
        spec = FlatSpec.for_tree(tree_map(
            lambda l: l.unsqueeze(0).expand((rows,) + tuple(l.shape)), row_tree))
        row_spec = FlatSpec.for_tree(tree_map(lambda l: l.unsqueeze(0), row_tree))
        params = torch.zeros((rows, spec.size), dtype=spec.dtype, device=device)
        # the port's optimizers initialise from shapes alone: one row's
        # state, repeated into every row
        init = optimizer.init(row_spec.unravel_row(params[0]))
        opt_state = tree_map(lambda l: l.unsqueeze(0).repeat((rows,) + (1,) * l.dim()),
                             init)
        del init
        return cls(
            spec=spec, row_spec=row_spec, params=params, opt_state=opt_state,
            spare=torch.empty_like(params) if spare else None,
            residual=(torch.zeros((rows, spec.size), dtype=torch.float32, device=device)
                      if error_feedback else None),
            workspace=(codec.workspace(rows, spec.size, device)
                       if codec is not None else None))

    def tree(self):
        """The (rows, ...) parameter tree, as views of ``params``."""
        return self.spec.unravel(self.params)

    def row(self, r: int):
        """Row ``r``'s (unstacked) parameter tree, as views."""
        return self.row_spec.unravel_row(self.params[r])

    def write_row(self, r: int, row_tree) -> None:
        """Write one client's (unstacked) tree into row ``r``."""
        self.row_spec.ravel(tree_map(lambda l: l.unsqueeze(0), row_tree),
                            out=self.params[r:r + 1])

    def swap(self) -> None:
        """After a round the mixer wrote into ``spare``: it becomes the
        parameters, and the round's input the next spare."""
        self.params, self.spare = self.spare, self.params

    def buffers(self) -> set:
        """The ``data_ptr`` of every resident buffer."""
        ts = [self.params, self.spare, self.residual,
              *(self.workspace or {}).values(), *tree_flatten(self.opt_state)[0]]
        return {t.data_ptr() for t in ts if t is not None}
