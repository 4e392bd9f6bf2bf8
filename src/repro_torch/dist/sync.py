"""FedLay mixing: the overlay's schedule turned into mixing rounds.

The port of ``repro/dist/sync.py``.  The control plane
(:mod:`repro_torch.core.ndmp`, :mod:`repro_torch.overlay.controller`)
freezes the overlay into a :class:`~repro_torch.core.mixing.PermuteSchedule`
(2L ring sources + MEP confidence weights); two mixer families turn it
into a mixing round:

* :func:`global_mixer` — one resident population, the client axis the
  leading dim of every tensor (``sync.py:395-600``):

  - ``fuse="flat"`` — the hot path.  The params tree is one lane-padded
    (C, N) buffer (:class:`repro_torch.dist.flat.FlatSpec`) and the whole
    round is one :func:`repro_torch.kernels.gather_mix.gather_mix` call:
    static (C, 2L+1) source rows (self first, then the schedule's perms)
    and a runtime weight table.  Masking (dead capacity slots, multirate
    skips, unreachable edges) only rewrites the weight table.
  - ``fuse=None`` / ``"tree"`` — the per-leaf walk over the tree, the
    reference's unfused path.
  - ``codec=`` (:mod:`repro_torch.wire.codec`; implies ``fuse="flat"``)
    — the wire-compressed round (``sync.py:553-570``): the population is
    encoded once a round, the neighbour term mixes the encoded form
    through the codec's ``gather`` (int8-block: ``gather_mix_int8``) and
    the self term uses the true rows through ``mix_accumulate``.  An
    error-feedback codec encodes ``buf + residual`` and carries the
    residual.

* :func:`fedlay_mix` / :func:`make_mixer` — the per-rank mixer, the
  counterpart of the reference's ``shard_map`` program
  (``sync.py:143-392``): every rank of a ``torch.distributed`` process
  group runs it on its own G clients.  ``ppermute`` becomes
  point-to-point sends and receives (``dist.batch_isend_irecv``),
  ``pmean`` ``dist.all_reduce``, ``axis_index`` the rank and ``psum(1)``
  the world size.  With one client a rank each slot is one exchange of
  the full row; with G > 1 edges whose source lies on the same rank are
  local takes (zero network bytes) and cross-rank edges run as the
  edge-colored rounds of :func:`repro_torch.core.mixing.grouped_routing`.
  Each slot's received rows fold into the accumulator with
  ``mix_accumulate``, or with a codec through its ``accumulate``
  (int8-block: ``dequant_accumulate``).

**The grouped (G, ...) contract** (per-rank mixer, the reference's):
client ``i`` lives on rank ``i // G`` at local row ``i % G``; every tree
leaf carries a leading local-client dim of size G, ``weights`` is the
rank's (G, 2L) slice of the schedule's weight table, ``self_weight`` its
(G,) slice and ``mask``, when given, its (G,) slice of the (n,) mask.
So ``sched.num_clients == G × world size``.  Every part crosses the
wire as the bytes of its rows (a ``uint8`` view, exact for every dtype),
and each rank builds its list of sends and receives from the host-static
routing tables, so all ranks agree on every exchange.

:func:`sync_bytes_per_client` is the paper's per-round communication
accounting (§IV-D): grouped mixing pays network bytes for cross-rank
edges only.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

import torch.distributed as dist

from ..core.mixing import PermuteSchedule, check_group_size, grouped_routing
from ..kernels.gather_mix import gather_mix
from ..kernels.mix_accumulate import mix_accumulate
from ..wire.codec import get_codec
from .flat import FlatSpec, tree_flatten, tree_map

#: Sync strategies understood by both mixer families.
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


def _group_layout(group):
    """(rank, world size) in ``group`` (None: the default group); raises
    when no process group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the per-rank mixer runs inside an initialized torch.distributed "
            "process group (repro_torch.launch.mesh.make_client_mesh)")
    return dist.get_rank(group), dist.get_world_size(group)


def _wire_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor, as a uint8 view of its storage."""
    return t.reshape(-1).view(torch.uint8)


def _empty(like: torch.Tensor) -> torch.Tensor:
    """A contiguous buffer of ``like``'s shape, dtype and device, whose
    rows a receive may write through byte views."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _exchange(ops) -> None:
    """Run one batch of point-to-point sends and receives and wait for it;
    a rank with nothing to send or receive in it makes no call."""
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _receiver(sched: PermuteSchedule, G: int, rank: int, group) -> Callable:
    """``receive(parts, k, outs)``: for each (G, ...) tensor of ``parts``,
    the rows the rank's G clients receive in slot k, written into the
    matching tensor of ``outs`` and returned.  The parts of one exchange
    travel together, one tag each (``sync.py:218-239``)."""
    world = dist.group.WORLD if group is None else group

    def p2p(op, t, r, tag):
        return dist.P2POp(op, _wire_bytes(t), dist.get_global_rank(world, r), group, tag)

    if G == 1:
        # one client a rank: every slot is one exchange of the full row
        # (the reference's one ppermute a slot, zero-weight edges too)
        def receive(parts, k, outs):
            perm = sched.perms[k]
            src, dst = perm[rank], perm.index(rank)
            ops = []
            for tag, (x, o) in enumerate(zip(parts, outs)):
                if src == rank:
                    o.copy_(x)
                    continue
                ops += [p2p(dist.isend, x, dst, tag), p2p(dist.irecv, o, src, tag)]
            _exchange(ops)
            return outs
        return receive

    rt = grouped_routing(sched, G)

    def receive(parts, k, outs):
        isrc, ion = rt.intra_src[k][rank], rt.intra_on[k][rank]
        for x, o in zip(parts, outs):
            # one copy a row, a device-to-device memcpy: on an H100 the
            # int8-block round's takes at 8 clients take 10.1 ms so,
            # 12.6 ms as one index_select a part
            for row in range(G):
                if ion[row] > 0:                 # an intra-rank edge: a take
                    o[row].copy_(x[int(isrc[row])])
                else:                            # cross-rank, or no edge
                    o[row].zero_()
        for rnd in rt.rounds[k]:
            dst = [d for s, d in rnd.pairs if s == rank]
            src = [s for s, d in rnd.pairs if d == rank]
            ops = []
            for tag, (x, o) in enumerate(zip(parts, outs)):
                if dst:
                    ops.append(p2p(dist.isend, x[int(rnd.send_row[rank])], dst[0], tag))
                if src:
                    ops.append(p2p(dist.irecv, o[int(rnd.recv_slot[rank])], src[0], tag))
            _exchange(ops)
        return outs
    return receive


def fedlay_mix(tree, sched: PermuteSchedule, weights, self_weight,
               group=None, mask=None, fuse: Optional[str] = None,
               codec=None, residual: Optional[torch.Tensor] = None, *,
               buf: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None, workspace=None):
    """One FedLay mixing round on this rank's G clients (the reference's
    ``shard_map`` body, ``sync.py:143-303``), over the process group
    ``group`` (None: the default group).

    ``tree`` leaves carry the leading local-client dim G (the module's
    grouped contract), ``weights`` is the rank's (G, 2L) weight slice and
    ``self_weight`` its (G,) self weights; the round equals the dense
    ``W @ X`` of :func:`repro_torch.core.mixing.schedule_mixing_matrix`.
    A schedule for other than G × world-size clients raises
    ``ValueError``; with no initialized process group the call raises
    ``RuntimeError``.

    ``mask`` (the rank's (G,) 0/1 slice) makes the round mask-aware: a
    masked-out client keeps its own model, live clients drop its
    contribution and renormalize over the surviving weights — the
    per-rank image of :func:`repro_torch.core.mixing.masked_mixing_matrix`.
    The mask's rows ride the same routing as the models.

    ``fuse="flat"`` runs the round on the flat buffer: the tree is raveled
    into a lane-padded (G, N) buffer and each slot's received rows stream
    into the accumulator through ``mix_accumulate``.  ``codec`` (implies
    the flat path) sends each slot the *encoded* parts of the rows
    through the same routing and folds them with the codec's
    ``accumulate`` (int8-block: ``dequant_accumulate``); the self term
    uses the true rows.  An error-feedback codec needs ``residual``
    ((G, N) f32): the wire carries ``enc(buf + residual)``, the residual
    is updated in place (masked-out rows keep theirs) and the call
    returns ``(tree, residual)``.

    The port's buffers, flat path only: ``buf`` is the (G, N) buffer the
    tree is raveled into (free for a tree of views of it, as
    :meth:`~repro_torch.dist.flat.FlatSpec.unravel` gives); ``out`` the
    (G, N) buffer the round writes, whose views the returned tree holds
    (allocated when None; never ``buf``, which the round reads after it
    writes ``out``); ``workspace`` the codec's
    :meth:`~repro_torch.wire.codec.WireCodec.workspace` for the round's
    wire.  The received rows of a slot land in buffers allocated once a
    call."""
    codec, fuse = resolve_wire(codec, fuse)
    ef = codec is not None and codec.error_feedback
    if ef and residual is None:
        raise ValueError(
            f"codec {codec.name!r} uses error feedback; pass the (G, N) "
            f"residual state (and use the returned residual)")
    if fuse != "flat" and not (buf is None and out is None and workspace is None):
        raise ValueError("buf, out and workspace are buffers of the flat path "
                         "(fuse='flat' or a codec)")
    leaves = tree_flatten(tree)[0]
    G, device = leaves[0].shape[0], leaves[0].device
    rank, world = _group_layout(group)
    if sched.num_clients != G * world:
        raise ValueError(
            f"schedule is for {sched.num_clients} clients but the grouped "
            f"layout holds {G} x {world} ranks")
    receive = _receiver(sched, G, rank, group)
    weights = torch.as_tensor(weights, device=device)
    self_weight = torch.as_tensor(self_weight, device=device)
    masked = mask is not None
    if masked:
        m = torch.as_tensor(mask, dtype=torch.float32, device=device).reshape(G)
        got = _empty(m)
        eff = [weights[:, k].float() * receive((m,), k, (got,))[0]
               for k in range(sched.num_slots)]
        total = self_weight.float() + sum(eff)
        ok = (m > 0) & (total > 0)
        safe = torch.where(total > 0, total, torch.ones_like(total))
        self_w = self_weight.float() / safe
        slot_w = [e / safe for e in eff]
    else:
        self_w = self_weight
        slot_w = [weights[:, k] for k in range(sched.num_slots)]

    if fuse == "flat":
        spec = FlatSpec.for_tree(tree)
        buf = spec.ravel(tree, out=buf)                    # (G, N)
        if out is None:
            out = torch.empty_like(buf)
        elif out.data_ptr() == buf.data_ptr():
            raise ValueError("the round reads buf after it writes out: "
                             "out must not be buf")
        if codec is None:
            wire = (buf,)
        elif ef:
            if tuple(residual.shape) != tuple(buf.shape):
                raise ValueError(f"residual shape {tuple(residual.shape)} != flat "
                                 f"buffer {tuple(buf.shape)}")
            operand = torch.add(buf, residual, out=out)
            kept = _kept_rows(m.cpu().numpy(), G) if masked else None
            if kept is None:
                wire, _ = codec.encode_ef(operand, workspace, residual_out=residual)
            else:
                # masked-out rows keep their residual: they sent nothing
                wire, fresh = codec.encode_ef(operand, workspace, residual_out=operand)
                for r in kept:
                    residual[r].copy_(fresh[r])
        else:
            wire = codec.encode(buf, workspace)
        acc = mix_accumulate(None, buf, self_w, out=out)
        got = tuple(_empty(part) for part in wire)
        for k in range(sched.num_slots):
            recv = receive(wire, k, got)
            if codec is None:
                mix_accumulate(acc, recv[0], slot_w[k], out=acc)
            else:
                codec.accumulate(acc, recv, slot_w[k], out=acc)
        if masked:
            for r in _rows(~ok):
                acc[r].copy_(buf[r])
        mixed = spec.unravel(acc)
        return (mixed, residual) if ef else mixed

    def mix_leaf(leaf):
        shape = _row_shape(leaf)
        acc = leaf * self_w.reshape(shape).to(leaf.dtype)
        x, got = leaf.contiguous(), _empty(leaf)
        for k in range(sched.num_slots):
            recv = receive((x,), k, (got,))[0]
            acc = acc + recv * slot_w[k].reshape(shape).to(leaf.dtype)
        return torch.where(ok.reshape(shape), acc, leaf) if masked else acc
    return tree_map(mix_leaf, tree)


def make_mixer(strategy: str, sched: Optional[PermuteSchedule], group,
               num_clients: int, clients_per_device: int = 1,
               fuse: Optional[str] = None, codec=None) -> Callable:
    """A per-rank mixer ``(tree, weights, self_w) -> tree`` for one sync
    strategy over the process group ``group`` (None: the default group),
    where the reference's ``make_mixer`` (``sync.py:306-392``) takes a
    ``shard_map`` axis name.

    ``num_clients`` is the total client count; with
    ``clients_per_device = G`` the group holds ``num_clients / G`` ranks
    and tree leaves carry the grouped leading (G, ...) dim.  ``fuse`` and
    ``codec`` select the flat path and the wire codec of the fedlay and
    ring rounds (:func:`fedlay_mix`), whose mixers also take
    :func:`fedlay_mix`'s keyword-only buffers; for an error-feedback
    codec their signature grows a trailing residual, ``(tree, weights,
    self_w, residual) -> (tree, residual)``.  allreduce reduces in the
    network and none sends nothing, so both ignore ``fuse`` and
    ``codec``.

    * ``fedlay``    — the schedule's sources (paper §III); with G > 1
      intra-rank takes and edge-colored cross-rank rounds;
    * ``allreduce`` — the uniform mean over all clients: each rank's
      G-row mean in f32, then ``dist.all_reduce`` over the ranks and a
      division by the world size (``pmean``);
    * ``ring``      — the identity-ring neighbour average over all clients
      (ignores the schedule; the rank takes its rows of
      :func:`ring_schedule`'s tables);
    * ``none``      — isolated local training.
    """
    G = clients_per_device
    check_group_size(num_clients, G)
    codec, fuse = resolve_wire(codec, fuse)
    ef = codec is not None and codec.error_feedback and strategy in ("fedlay", "ring")

    if strategy == "none":
        return lambda tree, weights, self_w: tree

    if strategy == "allreduce":
        def allreduce_mixer(tree, weights, self_w):
            _, world = _group_layout(group)

            def mean_leaf(leaf):
                m = leaf.float().mean(dim=0, keepdim=True)
                dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
                return (m / world).to(leaf.dtype).expand(leaf.shape).clone()
            return tree_map(mean_leaf, tree)
        return allreduce_mixer

    if strategy == "ring":
        ring = ring_schedule(num_clients)

        def rows(table):
            rank = _group_layout(group)[0]
            return table[rank * G:(rank + 1) * G]

        if ef:
            def ring_mixer_ef(tree, weights, self_w, residual, **kw):
                return fedlay_mix(tree, ring, rows(ring.weights), rows(ring.self_weight),
                                  group, fuse=fuse, codec=codec, residual=residual, **kw)
            return ring_mixer_ef

        def ring_mixer(tree, weights, self_w, **kw):
            return fedlay_mix(tree, ring, rows(ring.weights), rows(ring.self_weight),
                              group, fuse=fuse, codec=codec, **kw)
        return ring_mixer

    if strategy == "fedlay":
        if sched is None:
            raise ValueError("fedlay mixer needs a PermuteSchedule")
        if sched.num_clients != num_clients:
            raise ValueError(
                f"schedule is for {sched.num_clients} clients, the group holds "
                f"{num_clients} (= {num_clients // G} ranks x {G})")
        if ef:
            return lambda tree, weights, self_w, residual, **kw: fedlay_mix(
                tree, sched, weights, self_w, group, fuse=fuse, codec=codec,
                residual=residual, **kw)
        return lambda tree, weights, self_w, **kw: fedlay_mix(
            tree, sched, weights, self_w, group, fuse=fuse, codec=codec, **kw)

    raise ValueError(
        f"unknown sync strategy {strategy!r}; choose from {SYNC_STRATEGIES}")


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


def round_bytes_per_client(cache: dict, strategy: str, model_bytes: int,
                           num_clients: int, codec=None, **kwargs):
    """``(wire, payload)`` bytes a client for one round, memoized in
    ``cache``: the wire image under ``codec`` beside the uncompressed
    row (equal without a codec), each from
    :func:`sync_bytes_per_client` with ``kwargs``.  A loop keeps one
    ``cache`` for its row size and codec."""
    key = (strategy, num_clients, tuple(sorted(kwargs.items())))
    cached = cache.get(key)
    if cached is None:
        wire = sync_bytes_per_client(strategy, model_bytes, num_clients,
                                     codec=codec, **kwargs)
        payload = (sync_bytes_per_client(strategy, model_bytes, num_clients,
                                         **kwargs)
                   if codec is not None else wire)
        cached = cache[key] = (wire, payload)
    return cached
