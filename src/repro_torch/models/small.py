"""The paper's client-side models (Table II) as DFL ``Task``s, on the
device: an MLP for MNIST-like digits, a CNN for CIFAR-like images and an
LSTM for next-character prediction.

The port of ``repro/models/small.py``.  The engines of
:mod:`repro_torch.core.dfl` exchange *flat f32 vectors*, exactly what
goes over the wire in the real system.  Here a flat vector is a 1-D
float32 tensor on the task's device, in the reference's layout:
``repro/models/small.py:_flatten`` is ``jax.tree.flatten`` of the
parameter dict, which orders the keys by name, each leaf row-major
(:func:`flat_layout`):

* ``MLPTask``: ``b1``, ``b2``, ``w1`` (d_in, hidden), ``w2`` (hidden, k);
* ``CNNTask``: ``b`` (k), ``b1`` (c), ``b2`` (2c), ``c1`` (3, 3, 3, c)
  and ``c2`` (3, 3, c, 2c), both HWIO, ``w`` (d_flat, k) over the
  activation flattened in NHWC order;
* ``LSTMTask``: ``b`` (4h), ``bo`` (v), ``emb`` (v, 32), ``wh`` (h, 4h),
  ``wo`` (h, v), ``wx`` (32, 4h), the gates along 4h in i, f, g, o order.

A flat vector therefore means the same model in both packages
(:func:`repro_torch.models.convert.task_params_from_jax`), and its
fingerprint (:func:`repro_torch.core.mep.model_fingerprint`) is the
same.

The data lives on the task's device.  ``local_train`` draws its batches
with numpy exactly as the reference does, gathers each batch on the
device with one index, and takes its SGD steps through autograd on views
of one flat tensor.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data.noniid import Partition
from ..data.synthetic import CharLMData, ClassificationData


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
        device.  Each step draws ``take`` with
        ``np.random.default_rng(seed)`` exactly as
        ``repro/models/small.py:70-73`` does and asks the task for its
        batch (``_batch_of``)."""
        p = params.detach().to(device=self.device, dtype=torch.float32, copy=True)
        idx = self.partition.client_indices[client]
        rng = np.random.default_rng(seed)
        for _ in range(self.local_steps):
            take = rng.choice(idx, size=min(self.batch, len(idx)), replace=False)
            batch = self._batch_of(take)
            p = p.detach().requires_grad_(True)
            loss = self._loss(self.unflatten(p), *batch)
            (grad,) = torch.autograd.grad(loss, p)
            p = p.detach() - self.lr * grad
        return p

    @torch.no_grad()
    def evaluate(self, params: torch.Tensor) -> float:
        """Test accuracy of a flat vector, as a float."""
        p = params.to(device=self.device, dtype=torch.float32)
        return float(self._accuracy(self.unflatten(p)))

    # -- shared by the tasks: softmax cross-entropy over ``_logits`` --------
    def _batch_of(self, take) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rows ``take`` of the training set: one gather on the device."""
        rows = torch.from_numpy(np.asarray(take, np.int64)).to(self.device)
        return self._xtr[rows], self._ytr[rows]

    def _loss(self, t: Dict[str, torch.Tensor], x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
        logits = self._logits(t, x)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))

    def _accuracy(self, t: Dict[str, torch.Tensor]) -> torch.Tensor:
        pred = self._logits(t, self._xte).argmax(dim=-1)
        return (pred == self._yte).float().mean()


def _on(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


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
        self._xtr = _on(data.x_train, np.float32, dev)
        self._ytr = _on(data.y_train, np.int64, dev)
        self._xte = _on(data.x_test, np.float32, dev)
        self._yte = _on(data.y_test, np.int64, dev)

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


# --------------------------------------------------------------------------
# CNN on CIFAR-like
# --------------------------------------------------------------------------

class CNNTask(_TaskBase):
    """Two 3×3 "SAME" convolutions (stride 1), each with bias, ReLU and a
    2×2 "VALID" max pool, then a dense layer, with softmax
    cross-entropy: the reference's ``CNNTask`` on the device.

    The images arrive NHWC and are kept NCHW on the device, as
    ``F.conv2d`` takes them; the conv kernels are HWIO views of the flat
    vector permuted to OIHW, so gradients flow back into the flat tensor.
    The second pool's output is flattened in NHWC order before ``w``, so
    ``w``'s rows mean what the reference's do."""

    def __init__(self, data: ClassificationData, partition: Partition,
                 channels: int = 16, lr: float = 0.05, batch: int = 32,
                 local_steps: int = 4, device="cuda"):
        self.ch = channels
        self.k = data.num_classes
        h = data.x_train.shape[1]
        self.d_flat = (h // 4) * (h // 4) * (2 * channels)
        super().__init__(data, partition, data.y_train, lr, batch, local_steps,
                         device)
        dev = self.device
        nchw = (0, 3, 1, 2)
        self._xtr = _on(np.transpose(data.x_train, nchw), np.float32, dev)
        self._ytr = _on(data.y_train, np.int64, dev)
        self._xte = _on(np.transpose(data.x_test, nchw), np.float32, dev)
        self._yte = _on(data.y_test, np.int64, dev)

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        c = self.ch
        return {"c1": (3, 3, 3, c), "b1": (c,), "c2": (3, 3, c, 2 * c),
                "b2": (2 * c,), "w": (self.d_flat, self.k), "b": (self.k,)}

    def _init_tree(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        c = self.ch
        return {
            "c1": torch.randn((3, 3, 3, c), generator=gen) * 0.1,
            "b1": torch.zeros(c),
            "c2": torch.randn((3, 3, c, 2 * c), generator=gen) * 0.1,
            "b2": torch.zeros(2 * c),
            "w": torch.randn((self.d_flat, self.k), generator=gen) * (1 / np.sqrt(self.d_flat)),
            "b": torch.zeros(self.k),
        }

    @staticmethod
    def _logits(t: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        for conv, bias in (("c1", "b1"), ("c2", "b2")):
            x = F.conv2d(x, t[conv].permute(3, 2, 0, 1), t[bias], padding=1)
            x = F.max_pool2d(F.relu(x, inplace=True), 2)
        x = x.permute(0, 2, 3, 1).reshape(len(x), -1)       # NHWC order
        return x @ t["w"] + t["b"]


# --------------------------------------------------------------------------
# LSTM on Shakespeare-like role streams
# --------------------------------------------------------------------------

class LSTMTask(_TaskBase):
    """Next-character prediction with a one-layer LSTM; each client holds
    the role streams ``c, c + n, …``: the reference's ``LSTMTask`` on the
    device.

    The cell is a plain loop of torch ops on views of the flat vector,
    from zero h and c: z = e_t·wx + h·wh + b, split along 4h into i, f,
    g, o; c = σ(f)·c + σ(i)·tanh(g); h = σ(o)·tanh(c) (``nn.LSTM``'s
    (4h, e) weights and two biases are not the wire's layout).  The loss
    is the mean gold log-probability over (batch, seq); accuracy is taken
    over the test stream cut to whole windows of ``seq``.

    ``_batch_of`` seeds its RNG with ``sum(roles) + 1``, as
    ``repro/models/small.py:271-280`` does: a client's draws do not
    depend on the step's seed, so it gets the same window offsets at
    every local step and every wake-up (the same windows whenever
    ``take`` lists its roles in the same order).  That is the reference's
    behaviour and is kept."""

    EMBED = 32

    def __init__(self, data: CharLMData, num_clients: int, hidden: int = 64,
                 seq: int = 32, lr: float = 0.5, batch: int = 16,
                 local_steps: int = 4, device="cuda"):
        roles = data.role_streams.shape[0]
        assign = [list(range(c, roles, num_clients)) for c in range(num_clients)]
        part = Partition(client_indices=[np.array(a) for a in assign],
                         num_classes=10)
        self.vocab = data.vocab_size
        self.hidden = hidden
        self.seq = seq
        super().__init__(data, part, data.role_labels, lr, batch, local_steps,
                         device)
        dev = self.device
        self._streams = _on(data.role_streams, np.int64, dev)
        test = np.asarray(data.test_stream, np.int64)
        n = (len(test) - 1) // seq
        self._xte = _on(test[:n * seq].reshape(n, seq), np.int64, dev)
        self._yte = _on(test[1:n * seq + 1].reshape(n, seq), np.int64, dev)
        self._window = torch.arange(seq + 1, device=dev)

    def _shapes(self) -> Dict[str, Tuple[int, ...]]:
        e, h, v = self.EMBED, self.hidden, self.vocab
        return {"emb": (v, e), "wx": (e, 4 * h), "wh": (h, 4 * h), "b": (4 * h,),
                "wo": (h, v), "bo": (v,)}

    def _init_tree(self, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        e, h, v = self.EMBED, self.hidden, self.vocab
        return {
            "emb": torch.randn((v, e), generator=gen) * 0.1,
            "wx": torch.randn((e, 4 * h), generator=gen) * (1 / np.sqrt(e)),
            "wh": torch.randn((h, 4 * h), generator=gen) * (1 / np.sqrt(h)),
            "b": torch.zeros(4 * h),
            "wo": torch.randn((h, v), generator=gen) * (1 / np.sqrt(h)),
            "bo": torch.zeros(v),
        }

    def _batch_of(self, roles) -> Tuple[torch.Tensor, torch.Tensor]:
        """(batch, seq) inputs and targets: every (role, t0) pair drawn on
        the host with the reference's calls in its order, then each
        ``seq + 1`` window gathered from the streams on the device with
        one index."""
        rng = np.random.default_rng(int(np.sum(roles)) + 1)
        stream_len = self._streams.shape[1]
        starts = np.empty((2, self.batch), np.int64)
        for i in range(self.batch):
            starts[0, i] = rng.choice(roles)
            starts[1, i] = rng.integers(0, stream_len - self.seq - 1)
        r, t0 = torch.from_numpy(starts).to(self.device)
        window = self._streams[r[:, None], t0[:, None] + self._window]
        return window[:, :-1], window[:, 1:]

    def _logits(self, t: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        ex = t["emb"][x] @ t["wx"] + t["b"]                 # (b, s, 4h)
        h = c = ex.new_zeros((x.shape[0], self.hidden))
        hs = []
        for s in range(x.shape[1]):
            i, f, g, o = (ex[:, s] + h @ t["wh"]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, dim=1) @ t["wo"] + t["bo"]   # (b, s, v)
