"""End-to-end DFL training entry point: the paper's system on the GPU path.

The port of ``repro/launch/train.py``.  Each rank of a
``torch.distributed`` client group (:mod:`repro_torch.launch.mesh`, one
rank a card) hosts ``--clients-per-device`` FedLay clients (G, default
1): full model replicas training on their own non-iid token shards.
After every local step the clients mix models over the FedLay overlay
with the per-rank mixer (:func:`repro_torch.dist.sync.make_mixer`:
point-to-point exchanges with MEP confidence weights; with G > 1
intra-rank edges never touch the wire), or with the baselines
(``allreduce`` = centralized FedAvg aggregation, ``ring``, ``none`` =
isolated local training).

A rank's G models live as row views of one resident (G, N) flat buffer,
updated in place by the local step; the flat mixer writes the round into
a second buffer and the two swap roles every step, so a step allocates
nothing of N's size beyond one client's gradients and the mixer's
received rows (one slot's, allocated each call: f32 rows codec-free,
their wire image under a codec).  The flat path (``--fuse flat`` or a
``--codec``) runs the mixing round through the ``mix_accumulate`` kernel
(int8-block: ``quantize_block`` and ``dequant_accumulate``).

On the CPU (gloo):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --clients 4 --clients-per-device 4 --steps 6 --d-model 64 \\
      --layers 2 --batch 4 --seq 32

On one card (the default device), and on several under ``torchrun``
(one rank a card, the group from its ``env://`` environment):

  PYTHONPATH=src python -m repro_torch.launch.train --clients 8 \\
      --clients-per-device 8 --fuse flat --codec int8-block
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --clients 8 --clients-per-device 4 --fuse flat

``--ckpt-dir D`` checkpoints the full training state every
``--ckpt-every`` steps and at the last one, in the reference's format
and leaf order, and a run started on a directory that holds a checkpoint
resumes from its newest: the same command with a larger ``--steps``
continues a run, bit for bit with one that was never stopped.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..ckpt.checkpoint import CheckpointManager, state_leaves
from ..configs import tiny_lm
from ..core.mixing import build_permute_schedule
from ..data.tokens import TokenStream
from ..dist.flat import tree_flatten
from ..dist.sync import SYNC_STRATEGIES, make_mixer, resolve_wire, sync_bytes_per_client
from ..models.config import ArchConfig
from ..models.model import init_params
from ..obs import RoundLedger, Telemetry, capture, round_ledger, telemetry
from ..optim.optimizers import adamw
from ..runtime.resident import Resident
from .mesh import ClientMesh, make_client_mesh
from .steps import dfl_local_step

__all__ = ["main", "make_dfl_step", "rank_state", "run", "tiny_lm"]


def rank_state(params, clients: int, optimizer, *, flat: bool, codec=None,
               error_feedback: bool = False, device=None) -> Resident:
    """A rank's resident state (:class:`repro_torch.runtime.resident.Resident`)
    for ``clients`` G clients that all start from ``params`` (one
    client's tree, written into each row), on ``device`` (default the
    tree's): the (G, N) flat buffer, the optimizer's state for each row,
    and on the ``flat`` path the mixer's output buffer, the codec's
    workspace and the error-feedback residual.  The tree, the allreduce
    and none strategies return new tensors, which the step copies back
    into the buffer, so they get no output buffer."""
    state = Resident.allocate(params, clients, optimizer, spare=flat,
                              codec=codec if flat else None,
                              error_feedback=error_feedback, device=device)
    for g in range(clients):
        state.write_row(g, params)
    return state


def make_dfl_step(cfg: ArchConfig, optimizer, mixer, group,
                  error_feedback: bool = False):
    """One DFL round on this rank's G clients (``train.py:55-98``):
    ``step(state, batch, weights, self_w) -> loss``.

    Every client's ``value_and_grad`` of the training loss,
    ``clip_by_global_norm(·, 1.0)`` and the optimizer's update
    (:func:`repro_torch.launch.steps.dfl_local_step`, every client live),
    written into ``state.params`` in place; then ``mixer`` (a
    :func:`repro_torch.dist.sync.make_mixer` mixer over ``group``) with
    the rank's (G, 2L) ``weights`` and (G,) ``self_w``.  On the flat path
    (``state.spare`` set) the mixer reads ``state.params`` and writes
    ``state.spare`` (``buf=`` / ``out=`` / ``workspace=``), and the two
    swap roles; otherwise its result is copied into ``state.params``.
    With ``error_feedback`` the (G, N) residual is carried through the
    round in place.  ``batch`` is ``{"tokens", "labels"}`` of (G, B, S)
    ints.  Returns the group's mean loss, a 0-dim f32 tensor: the rank's
    mean over its clients, all-reduced (the reference's
    ``pmean(mean(loss))``)."""
    local = dfl_local_step(cfg, optimizer)

    def step(state: Resident, batch, weights, self_w) -> torch.Tensor:
        G = state.params.shape[0]
        tree = state.tree()
        _, _, metrics = local(tree, state.opt_state, batch, np.ones(G, np.float32))
        args = (tree, weights, self_w) + ((state.residual,) if error_feedback else ())
        if state.spare is not None:
            kw = {"buf": state.params, "out": state.spare}
            if state.workspace is not None:
                kw["workspace"] = state.workspace
            mixer(*args, **kw)
            state.swap()
        else:
            state.spec.ravel(mixer(*args), out=state.params)
        loss = metrics["loss"].float()
        dist.all_reduce(loss, group=group)
        return loss / dist.get_world_size(group)
    return step


def _join(device: torch.device) -> ClientMesh:
    """The run's client group: from ``torchrun``'s environment when it is
    set, else a one-rank group on a free localhost port."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return make_client_mesh(device=device)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return make_client_mesh(0, 1, f"tcp://127.0.0.1:{port}", device=device)


def run(args, mesh: Optional[ClientMesh] = None) -> Dict:
    """Train as ``args`` (``main``'s flags) say, as this rank of ``mesh``
    (None: join a group as :func:`_join` does, and leave it at the end).
    Returns the result that ``--out`` holds; rank 0 alone prints and
    writes files."""
    if mesh is None:
        mesh = _join(resolve_device(getattr(args, "device", "cuda")))
        try:
            return _run(args, mesh)
        finally:
            mesh.close()
    want = torch.device(getattr(args, "device", mesh.device.type))
    if want.type != mesh.device.type:
        raise ValueError(f"--device {want.type} on a client group of "
                         f"{mesh.device.type} ranks")
    return _run(args, mesh)


def _host_leaves(leaves, group, rank: int, world: int) -> Optional[List[torch.Tensor]]:
    """The group's training state for a checkpoint, on rank 0's host.

    Rank 0 gets every (G, ...) leaf with every rank's rows in rank order,
    an (n, ...) host tensor each; it copies its own rows and receives
    each other rank's into one buffer of a rank's rows of one leaf, a
    leaf and a rank at a time, so that no card holds more than one
    leaf's rows beyond its own state.  Every other rank sends its rows,
    a leaf at a time, and gets None."""
    if rank:
        dst = dist.get_global_rank(group, 0)
        for leaf in leaves:
            dist.send(leaf.contiguous(), dst, group=group)
        return None
    out = []
    for leaf in leaves:
        G = leaf.shape[0]
        host = torch.empty((world * G,) + tuple(leaf.shape[1:]), dtype=leaf.dtype)
        host[:G].copy_(leaf)
        if world > 1:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype, device=leaf.device)
            for src in range(1, world):
                dist.recv(buf, dist.get_global_rank(group, src), group=group)
                host[src * G:(src + 1) * G].copy_(buf)
            del buf
        out.append(host)
    return out


def _run(args, mesh: ClientMesh) -> Dict:
    device, rank, world = mesh.device, mesh.rank, mesh.size
    G = args.clients_per_device
    n = args.clients if args.clients is not None else world * G
    if n % G:
        raise SystemExit(f"--clients {n} must be a multiple of "
                         f"--clients-per-device {G}")
    if n // G != world:
        raise SystemExit(f"--clients {n} at --clients-per-device {G} needs "
                         f"{n // G} ranks; the client group has {world}")
    lead = rank == 0
    cfg = tiny_lm(vocab=args.vocab, d_model=args.d_model, layers=args.layers)
    rows = range(rank * G, (rank + 1) * G)

    # every client starts from the same parameters (the standard DFL
    # assumption), drawn on the host so that every rank and device agree
    p0 = init_params(cfg, torch.Generator().manual_seed(args.seed))
    optimizer = adamw(args.lr, weight_decay=0.0)
    codec_name = getattr(args, "codec", None)
    codec, fuse = resolve_wire(codec_name, getattr(args, "fuse", None))
    mixing = args.sync in ("fedlay", "ring")
    ef = codec is not None and codec.error_feedback and mixing
    state = rank_state(p0, G, optimizer, flat=mixing and fuse == "flat", codec=codec,
                       error_feedback=ef, device=device)
    row_elems = sum(l.numel() for l in tree_flatten(p0)[0])
    del p0

    # the FedLay overlay over client ids 0..n-1, compiled to the exchange
    # schedule (MEP confidence weights)
    sched = build_permute_schedule(n, args.spaces)
    mixer = make_mixer(args.sync, sched, mesh.group, n, clients_per_device=G,
                       fuse=getattr(args, "fuse", None), codec=codec_name)
    weights = torch.as_tensor(sched.weights[rows.start:rows.stop], device=device)
    self_w = torch.as_tensor(sched.self_weight[rows.start:rows.stop], device=device)
    step_fn = make_dfl_step(cfg, optimizer, mixer, mesh.group, error_feedback=ef)

    # non-iid client shards
    streams = [iter(TokenStream(cfg.vocab_size, args.batch, args.seq,
                                seed=args.seed, client=c)) for c in rows]

    # opt-in observability: --telemetry-out installs a bus and a
    # per-round ledger for the run; --profile-dir captures a trace
    telemetry_out = getattr(args, "telemetry_out", None)
    bus = Telemetry() if telemetry_out and lead else None
    ledger = RoundLedger(bus=bus) if bus is not None else None
    wire = sync_bytes_per_client(args.sync, 4 * row_elems, n, num_spaces=args.spaces,
                                 clients_per_device=G, codec=codec_name)
    payload = (sync_bytes_per_client(args.sync, 4 * row_elems, n,
                                     num_spaces=args.spaces, clients_per_device=G)
               if codec_name is not None else wire)

    # crash/resume: --ckpt-dir checkpoints the full training state (every
    # leaf with its leading n client dim, in the reference's leaf order)
    # and resumes from the newest checkpoint.  The streams are
    # deterministic in (seed, client, step), so replaying from step k is
    # exact.
    def training_state():
        out = {"params": state.tree(), "opt_state": state.opt_state}
        if ef:
            out["residual"] = state.residual
        return out

    manager, start_step = None, 0
    ckpt_dir = getattr(args, "ckpt_dir", None)
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir)
        if manager.latest() is not None:
            tree, meta = manager.restore()
            have, want = tree["leaves"], state_leaves(training_state())
            if len(have) != len(want):
                raise ValueError(f"checkpoint has {len(have)} leaves, this run "
                                 f"expects {len(want)}")
            for h, w in zip(have, want):
                if (tuple(h.shape) != (n,) + tuple(w.shape[1:])
                        or h.dtype != w.dtype):
                    raise ValueError(f"leaf mismatch: checkpoint {tuple(h.shape)}/"
                                     f"{h.dtype} vs this run's {n} x "
                                     f"{tuple(w.shape[1:])}/{w.dtype}")
                w.copy_(h[rows.start:rows.stop])
            start_step = int(meta["step"])
            for s in streams:                  # fast-forward to the resume point
                for _ in range(start_step):
                    next(s)
            if lead:
                print(f"resumed from {ckpt_dir} at step {start_step}", flush=True)

    losses = []
    t0 = time.time()
    with contextlib.ExitStack() as stack:
        if bus is not None:
            stack.enter_context(telemetry(bus))
            stack.enter_context(round_ledger(ledger))
        if getattr(args, "profile_dir", None) and lead:
            stack.enter_context(capture(args.profile_dir))
        for step in range(start_step, args.steps):
            xs, ys = zip(*(next(s) for s in streams))
            batch = {"tokens": torch.from_numpy(np.stack(xs)).to(device),
                     "labels": torch.from_numpy(np.stack(ys)).to(device)}
            losses.append(float(step_fn(state, batch, weights, self_w)))
            if ledger is not None:
                bus.count("train.steps")
                ledger.record(round=step, time=time.time() - t0, loop="train",
                              num_alive=n, participating=n, loss=losses[-1],
                              wire_bytes_per_client=wire,
                              payload_bytes_per_client=payload)
            if manager is not None and (
                    (step + 1) % max(getattr(args, "ckpt_every", 0), 1) == 0
                    or step == args.steps - 1):
                leaves = _host_leaves(state_leaves(training_state()), mesh.group,
                                      rank, world)
                if lead:
                    manager.save(step + 1, {"leaves": leaves})
                del leaves
            if lead and (step % args.log_every == 0 or step == args.steps - 1):
                print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                      f"({(time.time() - t0) / (step + 1 - start_step):.2f}s/step)",
                      flush=True)
    result = {"sync": args.sync, "clients": n, "clients_per_device": G,
              "steps": args.steps, "codec": codec_name, "start_step": start_step,
              "first_loss": losses[0] if losses else float("nan"),
              "final_loss": losses[-1] if losses else float("nan"),
              "losses": losses}
    if ledger is not None:
        rows_written = ledger.to_jsonl(telemetry_out)
        result["telemetry"] = ledger.summary()
        print(f"wrote {rows_written} round records to {telemetry_out}")
        print(ledger.summary_table())
    if args.out and lead:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return result


def parser() -> argparse.ArgumentParser:
    """The command line: the reference's flags and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run computes: cuda (NCCL, one rank a card) "
                         "or cpu (gloo)")
    ap.add_argument("--clients", type=int, default=None,
                    help="total clients (default: the group's ranks x "
                         "--clients-per-device)")
    ap.add_argument("--clients-per-device", type=int, default=1,
                    help="G local clients per rank (total clients = G x ranks)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--sync", default="fedlay", choices=list(SYNC_STRATEGIES))
    ap.add_argument("--fuse", default=None, choices=["tree", "flat"],
                    help="mixing-round execution: per-leaf tree walk (default) "
                         "or the flat buffer through the CUDA kernels")
    ap.add_argument("--codec", default=None,
                    choices=["none", "bf16", "int8-block", "int4-block", "topk"],
                    help="wire codec for the fedlay/ring gossip payload (implies "
                         "--fuse flat; lossy codecs carry an error-feedback "
                         "residual through the run)")
    ap.add_argument("--spaces", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="crash/resume: checkpoint the training state into DIR "
                         "every --ckpt-every steps and resume from the newest "
                         "checkpoint on startup")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (with --ckpt-dir)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--telemetry-out", default=None, metavar="PATH",
                    help="enable the telemetry plane for this run and write the "
                         "per-round ledger as JSONL to PATH (also prints the "
                         "summary table)")
    ap.add_argument("--profile-dir", default=None, metavar="PATH",
                    help="capture a torch.profiler trace of the run into PATH "
                         "(trace.json; view with Perfetto)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    res = run(args)
    if res["losses"] and int(os.environ.get("RANK", 0)) == 0:
        print(f"loss {res['first_loss']:.4f} -> {res['final_loss']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
