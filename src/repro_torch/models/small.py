"""The paper's client-side MLP (Table II) as a DFL ``Task``, on the device.

The port of ``repro/models/small.py``'s ``_TaskBase`` and ``MLPTask``;
``CNNTask`` and ``LSTMTask`` are not ported yet (ROADMAP.md, Queue 1
item 15).  The engines of :mod:`repro_torch.core.dfl` exchange *flat
f32 vectors*, exactly what goes over the wire in the real system.  Here
a flat vector is a 1-D float32 tensor on the task's device, in the
reference's layout: ``repro/models/small.py:_flatten`` is
``jax.tree.flatten`` of the parameter dict, which orders the keys by
name, so the vector holds ``b1``, ``b2``, ``w1`` (d_in, hidden) and
``w2`` (hidden, k), each row-major.  A flat vector therefore means the
same model in both packages
(:func:`repro_torch.models.convert.task_params_from_jax`), and its
fingerprint (:func:`repro_torch.core.mep.model_fingerprint`) is the
same.

The data lives on the task's device.  ``local_train`` draws its batches
with numpy exactly as the reference does and takes its SGD steps
through autograd on views of one flat tensor.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data.noniid import Partition
from ..data.synthetic import ClassificationData


def flat_layout(shapes: Dict[str, Tuple[int, ...]]) -> List[Tuple[str, int, Tuple[int, ...]]]:
    """``(name, offset, shape)`` of each leaf in the flat vector, in the
    reference's order (keys sorted by name, as ``jax.tree.flatten`` of a
    dict orders them)."""
    layout, off = [], 0
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        layout.append((name, off, shape))
        off += int(np.prod(shape)) if shape else 1
    return layout


class _TaskBase:
    """Shared local-SGD plumbing over a flat parameter vector."""

    def __init__(self, data, partition: Partition, labels: np.ndarray,
                 lr: float, batch: int, local_steps: int, device):
        self.data = data
        self.partition = partition
        self._labels = np.asarray(labels)
        self.num_clients = len(partition.client_indices)
        self.lr = lr
        self.batch = batch
        self.local_steps = local_steps
        self.device = resolve_device(device)
        self._layout = flat_layout(self._shapes())
        self.num_params = sum(int(np.prod(s)) for _, _, s in self._layout)

    # -- Task protocol -----------------------------------------------------
    def init_params(self, seed: int) -> torch.Tensor:
        """A new flat f32 vector on the task's device, drawn from a torch
        generator seeded with ``seed`` on the CPU (so one seed gives one
        vector on every device), with the reference's distributions; the
        reference's JAX draws cannot be reproduced (ROADMAP.md, rules)."""
        gen = torch.Generator().manual_seed(seed)
        tree = self._init_tree(gen)
        flat = torch.cat([tree[name].reshape(-1) for name, _, _ in self._layout])
        return flat.to(device=self.device, dtype=torch.float32)

    def label_histogram(self, client: int) -> np.ndarray:
        return self.partition.label_histogram(self._labels, client)

    def train_cost(self, client: int) -> float:
        return float(len(self.partition.client_indices[client]))

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of ``flat`` in the parameter tree's shapes."""
        return {name: flat[off:off + int(np.prod(shape))].view(shape)
                for name, off, shape in self._layout}

    def local_train(self, params: torch.Tensor, client: int, seed: int) -> torch.Tensor:
        """``local_steps`` SGD steps on ``client``'s data from ``params``
        (not changed), returning a new flat f32 vector on the task's
        device.  The batches are drawn with ``np.random.default_rng(seed)``
        exactly as ``repro/models/small.py:70-73`` draws them."""
        p = params.detach().to(device=self.device, dtype=torch.float32, copy=True)
        idx = self.partition.client_indices[client]
        rng = np.random.default_rng(seed)
        for _ in range(self.local_steps):
            take = rng.choice(idx, size=min(self.batch, len(idx)), replace=False)
            rows = torch.from_numpy(np.asarray(take, np.int64)).to(self.device)
            p = p.detach().requires_grad_(True)
            loss = self._loss(self.unflatten(p), rows)
            (grad,) = torch.autograd.grad(loss, p)
            p = p.detach() - self.lr * grad
        return p

    @torch.no_grad()
    def evaluate(self, params: torch.Tensor) -> float:
        """Test accuracy of a flat vector, as a float."""
        p = params.to(device=self.device, dtype=torch.float32)
        return float(self._accuracy(self.unflatten(p)))


# --------------------------------------------------------------------------
# MLP on MNIST-like (paper: 247 KB model)
# --------------------------------------------------------------------------

class MLPTask(_TaskBase):
    """A one-hidden-layer ReLU MLP with softmax cross-entropy: the
    reference's ``MLPTask`` on the device (``cuda`` unless ``device`` says
    otherwise; :func:`repro_torch.resolve_device`)."""

    def __init__(self, data: ClassificationData, partition: Partition,
                 hidden: int = 64, lr: float = 0.1, batch: int = 32,
                 local_steps: int = 4, device="cuda"):
        self.hidden = hidden
        self.d_in = data.x_train.shape[1]
        self.k = data.num_classes
        super().__init__(data, partition, data.y_train, lr, batch, local_steps,
                         device)
        dev = self.device
        self._xtr = torch.from_numpy(np.asarray(data.x_train, np.float32)).to(dev)
        self._ytr = torch.from_numpy(np.asarray(data.y_train, np.int64)).to(dev)
        self._xte = torch.from_numpy(np.asarray(data.x_test, np.float32)).to(dev)
        self._yte = torch.from_numpy(np.asarray(data.y_test, np.int64)).to(dev)

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {"w1": (self.d_in, self.hidden), "b1": (self.hidden,),
                "w2": (self.hidden, self.k), "b2": (self.k,)}

    def _init_tree(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        return {
            "w1": torch.randn((self.d_in, self.hidden), generator=gen) * (1 / np.sqrt(self.d_in)),
            "b1": torch.zeros(self.hidden),
            "w2": torch.randn((self.hidden, self.k), generator=gen) * (1 / np.sqrt(self.hidden)),
            "b2": torch.zeros(self.k),
        }

    @staticmethod
    def _logits(t: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ t["w1"] + t["b1"])
        return h @ t["w2"] + t["b2"]

    def _loss(self, t: Dict[str, torch.Tensor], rows: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(self._logits(t, self._xtr[rows]), self._ytr[rows])

    def _accuracy(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        pred = self._logits(t, self._xte).argmax(dim=-1)
        return (pred == self._yte).float().mean()
