"""FedLay mixing over the leading client axis of one resident population.

The port of the global-view half of ``repro/dist/sync.py``
(``global_mixer``, ``sync.py:395-600``).  The control plane
(:mod:`repro_torch.core.ndmp`, :mod:`repro_torch.overlay.controller`)
freezes the overlay into a :class:`~repro_torch.core.mixing.PermuteSchedule`
(2L ring sources + MEP confidence weights); :func:`global_mixer` turns it
into a mixing round over the client axis:

* ``fuse="flat"`` — the hot path.  The params tree is one lane-padded
  (C, N) buffer (:class:`repro_torch.dist.flat.FlatSpec`) and the whole
  round is one :func:`repro_torch.kernels.gather_mix.gather_mix` call:
  static (C, 2L+1) source rows (self first, then the schedule's perms)
  and a runtime weight table.  Masking (dead capacity slots, multirate
  skips, unreachable edges) only rewrites the weight table.
* ``fuse=None`` / ``"tree"`` — the per-leaf walk over the tree, the
  reference's unfused path.
* ``codec=`` (:mod:`repro_torch.wire.codec`; implies ``fuse="flat"``)
  — the wire-compressed round (``sync.py:553-570``): the population is
  encoded once a round, the neighbour term mixes the encoded form
  through the codec's ``gather`` (int8-block: ``gather_mix_int8``) and
  the self term uses the true rows through ``mix_accumulate``.  An
  error-feedback codec encodes ``buf + residual`` and carries the
  residual.

The ``shard_map`` mixers (``fedlay_mix``, ``make_mixer``) wait for
ROADMAP.md Queue 1 item 10.  :func:`sync_bytes_per_client` is the
paper's per-round communication accounting (§IV-D).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.mixing import PermuteSchedule, check_group_size
from ..kernels.gather_mix import gather_mix
from ..kernels.mix_accumulate import mix_accumulate
from ..wire.codec import get_codec
from .flat import FlatSpec, tree_flatten, tree_map

#: Sync strategies understood by :func:`global_mixer`.
SYNC_STRATEGIES = ("fedlay", "allreduce", "ring", "none")

#: Mixing-round execution modes: ``None``/``"tree"`` — the per-leaf tree
#: walk; ``"flat"`` — the FlatSpec + ``gather_mix`` fused round.
FUSE_MODES = (None, "tree", "flat")


def check_fuse(fuse: Optional[str]) -> Optional[str]:
    """Validate a fuse mode and normalize the default spelling
    (``"tree"`` ≡ ``None``, the unfused walk)."""
    if fuse not in FUSE_MODES:
        raise ValueError(
            f"unknown fuse mode {fuse!r}; choose from {FUSE_MODES}")
    return None if fuse == "tree" else fuse


def resolve_wire(codec, fuse: Optional[str]):
    """Normalize the ``(codec, fuse)`` pair shared by the mixing entry
    points.  Codecs work on the flat row buffer, so any codec — the
    exact ``"none"`` too — implies ``fuse="flat"``; without one the fuse
    mode passes through."""
    fuse = check_fuse(fuse)
    codec = get_codec(codec)
    if codec is not None:
        fuse = "flat"
    return codec, fuse


def ring_schedule(num_clients: int) -> PermuteSchedule:
    """The identity-ring overlay as a PermuteSchedule: one space, simple
    average over {self, predecessor, successor} (degenerates correctly
    at n ≤ 2, where the two directions collide)."""
    n = num_clients
    pred = tuple((i - 1) % n for i in range(n))
    succ = tuple((i + 1) % n for i in range(n))
    weights = np.zeros((n, 2), dtype=np.float64)
    self_w = np.ones((n,), dtype=np.float64)
    for i in range(n):
        seen = {i}
        for k, src in enumerate((pred[i], succ[i])):
            if src not in seen:
                weights[i, k] = 1.0
                seen.add(src)
    total = self_w + weights.sum(axis=1)
    weights /= total[:, None]
    self_w /= total
    return PermuteSchedule(num_clients=n, num_spaces=1, perms=(pred, succ),
                           weights=weights.astype(np.float32),
                           self_weight=self_w.astype(np.float32))


def _rows(flags: torch.Tensor):
    """The row indices where a (C,) bool tensor is true, on the host."""
    return torch.nonzero(flags.cpu()).flatten().tolist()


def _kept_rows(mask, C: int):
    """The rows of a (C,) 0/1 host mask that are set, or None when every
    row is."""
    kept = np.flatnonzero(np.asarray(mask) > 0)
    return None if len(kept) == C else kept.tolist()


def _row_shape(leaf: torch.Tensor):
    return (leaf.shape[0],) + (1,) * (leaf.dim() - 1)


def global_mixer(strategy: str,
                 sched: Optional[PermuteSchedule] = None,
                 masked: bool = False,
                 fuse: Optional[str] = None,
                 codec=None,
                 flat_io: bool = False) -> Callable:
    """A mixer ``params -> params`` over the leading client axis of a
    tree of (C, ...) tensors; the tensors' device is the mixer's.

    With ``masked=True`` the mixer is ``(params, mask, *, edge_mask=None)
    -> params``: ``mask`` is a (C,) 0/1 runtime input.  Masked-out rows
    keep their own model; live rows drop masked-out sources and
    renormalize — the device image of
    :func:`repro_torch.core.mixing.masked_mixing_matrix`.  ``edge_mask``
    (fedlay/ring) is a (C, 2L) 0/1 runtime input that drops single
    unreachable edges before renormalizing; allreduce accepts and
    ignores it.

    ``fuse="flat"`` (fedlay/ring) runs the round as one ``gather_mix``
    over the raveled (C, N) buffer.  ``flat_io=True`` (fedlay/ring with
    ``fuse="flat"``) makes the mixer take and return that buffer itself,
    and adds a keyword-only ``out``: the (C, N) buffer the round writes
    (allocated when None; it may be the input, for an in-place round).

    ``codec`` compresses the fedlay/ring round (see the module
    docstring); allreduce and none ignore it.  For an error-feedback
    codec the signature grows a trailing (C, N) f32 ``residual`` and the
    mixer returns ``(params, residual)``: the residual is updated in
    place, and masked-out rows keep theirs (``mask`` is then read on the
    host: a numpy array or a CPU tensor).  A codec's flat_io mixer also
    takes a keyword-only ``workspace``, the codec's
    :meth:`~repro_torch.wire.codec.WireCodec.workspace` for the round's
    wire.  With an error-feedback codec ``out`` holds ``buf + residual``
    until the round writes it, and with any lossy codec it must not be
    the input.
    """
    codec, fuse = resolve_wire(codec, fuse)
    if flat_io and (fuse != "flat" or strategy not in ("fedlay", "ring")):
        raise ValueError(
            "flat_io mixers operate on the raveled buffer: they "
            "require fuse='flat' (or a codec) and a fedlay/ring "
            "strategy")
    if strategy == "none":
        if masked:
            return lambda params, mask, *, edge_mask=None: params
        return lambda params: params

    if strategy == "allreduce":
        def allreduce(params):
            return tree_map(
                lambda l: l.float().mean(dim=0, keepdim=True).to(l.dtype)
                .expand(l.shape).clone(), params)

        def allreduce_masked(params, mask, *, edge_mask=None):
            def mean_leaf(leaf):
                m = torch.as_tensor(mask, dtype=torch.float32,
                                    device=leaf.device)
                mm = m.reshape(_row_shape(leaf))
                mean = (leaf.float() * mm).sum(dim=0, keepdim=True) \
                    / torch.clamp(m.sum(), min=1.0)
                out = mean.to(leaf.dtype).expand(leaf.shape)
                return torch.where(mm > 0, out, leaf)
            return tree_map(mean_leaf, params)
        return allreduce_masked if masked else allreduce

    if strategy not in ("fedlay", "ring"):
        raise ValueError(
            f"unknown sync strategy {strategy!r}; choose from {SYNC_STRATEGIES}")
    if sched is None:
        raise ValueError(f"{strategy} mixer needs a PermuteSchedule")
    C = sched.num_clients
    perms_np = np.array(sched.perms, np.int64)                   # (2L, C)
    # (C, 2L+1) static source rows: self first, then the 2L schedule sources
    srcs_np = np.concatenate([np.arange(C)[:, None], perms_np.T], axis=1)
    consts = {}

    def on(device):
        """The schedule's tables on ``device``, made once per device."""
        c = consts.get(device)
        if c is None:
            c = consts[device] = {
                "perms": torch.from_numpy(perms_np).to(device),
                "srcs": torch.from_numpy(srcs_np).to(device),
                "weights": torch.from_numpy(sched.weights).to(device),
                "self_w": torch.from_numpy(sched.self_weight).to(device)}
        return c

    def masked_tables(c, mask, edge_mask=None):
        """(sw (C,), ew (C, 2L), ok (C,)) of mask-renormalized weights,
        shared by the tree walk and the fused round (``sync.py:510``).
        A fully isolated live row degenerates to total = self_w > 0 and
        keeps its own model."""
        device = c["weights"].device
        m = torch.as_tensor(mask, dtype=torch.float32, device=device)
        eff = c["weights"] * m[c["perms"]].T
        if edge_mask is not None:
            eff = eff * torch.as_tensor(edge_mask, dtype=torch.float32,
                                        device=device)
        total = c["self_w"] + eff.sum(dim=1)
        ok = (m > 0) & (total > 0)
        safe = torch.where(total > 0, total, torch.ones_like(total))
        return c["self_w"] / safe, eff / safe[:, None], ok

    if fuse == "flat":
        ef = codec is not None and codec.error_feedback

        def round_flat(buf, table, ok=None, out=None, residual=None, keep=None,
                       workspace=None):
            """One fused round on the (C, N) buffer (``sync.py:542``).
            Codec-free, or with an exact codec: one gather over the full
            table, identity rows where ~ok.  With a lossy codec: the
            neighbours' columns mix the encoded buffer through the
            codec's gather into ``out``, the self column adds the true
            rows with mix_accumulate, and rows where ~ok are copied from
            ``buf``.  EF encodes ``buf + residual`` (formed in ``out``)
            and writes the fresh residual into ``residual`` (straight,
            when ``keep`` is None) or into its rows listed in ``keep``."""
            srcs = on(buf.device)["srcs"]
            if codec is None or codec.exact:
                if ok is not None:
                    ident = torch.zeros_like(table)
                    ident[:, 0] = 1.0
                    table = torch.where(ok[:, None], table, ident)
                if codec is None:
                    return gather_mix(buf, srcs, table, out=out)
                return codec.gather(codec.encode(buf, workspace), srcs, table,
                                    buf.shape[1], out=out, ws=workspace)
            if out is None:
                out = torch.empty_like(buf, dtype=torch.float32)
            elif out.data_ptr() == buf.data_ptr():
                raise ValueError("a lossy codec's round reads buf after it "
                                 "writes out: out must not be buf")
            if ef:
                operand = torch.add(buf, residual, out=out)
                if keep is None:
                    wire, _ = codec.encode_ef(operand, workspace, residual_out=residual)
                else:
                    wire, fresh = codec.encode_ef(operand, workspace,
                                                  residual_out=operand)
                    for r in keep:
                        residual[r].copy_(fresh[r])
            else:
                wire = codec.encode(buf, workspace)
            out = codec.gather(wire, srcs[:, 1:], table[:, 1:], buf.shape[1],
                               out=out, ws=workspace)
            mix_accumulate(out, buf, table[:, 0], out=out)
            if ok is not None:
                for r in _rows(~ok):
                    out[r].copy_(buf[r])
            return out

        def full_table(c):
            return torch.cat([c["self_w"][:, None], c["weights"]], dim=1)

        def masked_table(buf, mask, edge_mask):
            sw, ew, ok = masked_tables(on(buf.device), mask, edge_mask)
            return torch.cat([sw[:, None], ew], dim=1), ok

        def mix_buf(buf, *, out=None, workspace=None):
            return round_flat(buf, full_table(on(buf.device)), out=out,
                              workspace=workspace)

        def mix_buf_masked(buf, mask, *, edge_mask=None, out=None, workspace=None):
            table, ok = masked_table(buf, mask, edge_mask)
            return round_flat(buf, table, ok=ok, out=out, workspace=workspace)

        def mix_buf_ef(buf, residual, *, out=None, workspace=None):
            return round_flat(buf, full_table(on(buf.device)), out=out,
                              residual=residual, workspace=workspace), residual

        def mix_buf_masked_ef(buf, mask, residual, *, edge_mask=None, out=None,
                              workspace=None):
            # masked-out rows (dead slots, multirate skips) keep their
            # residual: they contributed nothing this round
            table, ok = masked_table(buf, mask, edge_mask)
            return round_flat(buf, table, ok=ok, out=out, residual=residual,
                              keep=_kept_rows(mask, C), workspace=workspace), residual

        inner = {(False, False): mix_buf, (True, False): mix_buf_masked,
                 (False, True): mix_buf_ef,
                 (True, True): mix_buf_masked_ef}[(masked, ef)]
        if flat_io:
            return inner

        if ef:
            def mix_flat_ef(params, *rest, **kw):
                spec = FlatSpec.for_tree(params)
                out, res = inner(spec.ravel(params), *rest, **kw)
                return spec.unravel(out), res
            return mix_flat_ef

        def mix_flat(params, *rest, **kw):
            spec = FlatSpec.for_tree(params)
            return spec.unravel(inner(spec.ravel(params), *rest, **kw))
        return mix_flat

    def walk(params, sw, ew, ok=None):
        c = on(tree_flatten(params)[0][0].device)

        def mix_leaf(leaf):
            shape = _row_shape(leaf)
            acc = leaf * sw.reshape(shape).to(leaf.dtype)
            for k in range(sched.num_slots):
                recv = leaf[c["perms"][k]]                  # permutation
                acc = acc + recv * ew[:, k].reshape(shape).to(leaf.dtype)
            return acc if ok is None else torch.where(ok.reshape(shape), acc, leaf)
        return tree_map(mix_leaf, params)

    def mix(params):
        c = on(tree_flatten(params)[0][0].device)
        return walk(params, c["self_w"], c["weights"])

    def mix_masked(params, mask, *, edge_mask=None):
        c = on(tree_flatten(params)[0][0].device)
        return walk(params, *masked_tables(c, mask, edge_mask))
    return mix_masked if masked else mix


def sync_bytes_per_client(strategy: str, model_bytes: int, num_clients: int,
                          num_spaces: Optional[int] = None,
                          clients_per_device: int = 1,
                          active_clients: Optional[int] = None,
                          codec=None) -> float:
    """*Network* bytes each **active** client sends per mixing round
    (paper §IV-D accounting), the closed forms of
    ``repro/dist/sync.py:sync_bytes_per_client``.

    With ``clients_per_device = G`` edges between clients on one device
    cost nothing; ``active_clients = K`` counts a cohort of K of the
    ``num_clients`` slots.  fedlay: ``min(2L, K−1) · (K−G)/(K−1) ·
    model_bytes``; ring: ``2·D_K/K · model_bytes`` with ``D_K = ⌈K/G⌉``
    occupied devices; complete: ``(K−G) · model_bytes``; allreduce:
    ``2·(D_K−1)/D_K · D_K/K · model_bytes``; none: 0.  A wire ``codec``
    reads ``model_bytes`` as the f32 flat row (``model_bytes / 4``
    elements) and makes fedlay, ring and complete ship
    ``codec.wire_bytes`` of it instead; allreduce ignores it."""
    n, G = num_clients, clients_per_device
    check_group_size(n, G)
    codec = get_codec(codec)
    if codec is not None and strategy in ("fedlay", "ring", "complete"):
        model_bytes = codec.wire_bytes(int(round(model_bytes / 4.0)))
    K = n if active_clients is None else int(active_clients)
    if not 1 <= K <= n:
        raise ValueError(f"active_clients {K} out of range for "
                         f"{n} clients")
    d_k = -(-K // G)                 # occupied devices, lowest-slot packing
    if strategy == "fedlay":
        if num_spaces is None:
            raise ValueError("fedlay accounting needs num_spaces")
        if K <= 1 or d_k == 1:
            return 0.0
        degree = min(2 * num_spaces, K - 1)
        return degree * model_bytes * (K - G) / (K - 1)
    if strategy == "ring":
        return 0.0 if d_k == 1 else 2.0 * d_k * model_bytes / K
    if strategy == "complete":
        return float(max(K - G, 0)) * model_bytes
    if strategy in ("allreduce", "fedavg"):
        return 2.0 * (d_k - 1) / d_k * d_k * model_bytes / K \
            if d_k > 1 else 0.0
    if strategy == "none":
        return 0.0
    raise ValueError(
        f"unknown sync strategy {strategy!r}; choose from "
        f"{SYNC_STRATEGIES + ('complete', 'fedavg')}")
