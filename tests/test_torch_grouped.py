"""The port's per-rank FedLay mixer on the CPU.

Host side: the port's ``grouped_routing``, ``grouped_mix_reference``,
``cross_pod_messages`` and ``pod_bias`` schedules against the
reference's on the same inputs (the checks of ``tests/test_grouped.py``).

Ranks: each layout (world size, G clients a rank) is spawned once for
the module, as gloo ranks that meet through a ``FileStore`` under the
test's temporary directory, and runs every case of the layout.  Each
case is held to the reference's ``make_mixer`` / ``fedlay_mix`` under
``shard_map`` at the same layout (world-size devices of the 8-device CPU
mesh, G clients a device: its intra-device takes, its edge-colored
rounds of ppermutes and its grouped codec fold; one program a layout,
run while the ranks run), and to the port's own ``global_mixer``, on
the same seeded numpy inputs, with leaves of ragged widths.  Every wait
is bounded: the group's timeout bounds each exchange and collective,
and the ranks are joined with a deadline that fails the module's tests
instead of hanging.  The ranks spawn once a process that runs the
module's tests: under xdist's ``--dist loadfile`` that is one worker;
a distribution that splits the module spawns them again in each worker
that takes one of its tests.

The spawned ranks import this module, so JAX and the reference package
are imported only inside the functions that run the reference.
"""

import datetime
import multiprocessing
import pathlib
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import mixing as tm
from repro_torch.core.ndmp import Simulator
from repro_torch.dist import sync
from repro_torch.dist.flat import FlatSpec
from repro_torch.dist.sharding import dfl_client_count
from repro_torch.dist.sync import (fedlay_mix, global_mixer, make_mixer, ring_schedule,
                                   sync_bytes_per_client)
from repro_torch.launch.mesh import (ClientMesh, data_axes, make_client_mesh,
                                     num_clients)
from repro_torch.overlay.controller import OverlayController
from repro_torch.overlay.events import ChurnTrace
from repro_torch.wire.codec import WIRE_CODECS, get_codec

#: Seconds a rank waits on the group (rendezvous, each exchange and
#: collective), and seconds the test waits for all ranks to finish.
INIT_S, JOIN_S = 60, 240
SALT = "grouped"
CODECS = tuple(WIRE_CODECS)

#: (world size, G clients a rank, C clients, L spaces), the port's and
#: the reference's.  The last layout runs the one-client-a-rank form of
#: the receive.
LAYOUTS = ((1, 8, 8, 2), (2, 4, 8, 2), (4, 2, 8, 2), (4, 1, 4, 1))

#: (name, entry, strategy, fuse, codec, masked): "make" calls make_mixer's
#: mixer, "mix" fedlay_mix with the rank's mask rows.
FULL_CASES = (
    ("tree-fedlay", "make", "fedlay", None, None, False),
    ("tree-ring", "make", "ring", None, None, False),
    ("tree-allreduce", "make", "allreduce", None, None, False),
    ("tree-none", "make", "none", None, None, False),
    ("flat-fedlay", "make", "fedlay", "flat", None, False),
    ("masked-tree", "mix", "fedlay", None, None, True),
    ("masked-flat", "mix", "fedlay", "flat", None, True),
    *((f"codec-{c}", "make", "fedlay", None, c, False) for c in CODECS),
    *((f"masked-codec-{c}", "mix", "fedlay", None, c, True) for c in CODECS),
    ("ring-int8-block", "make", "ring", None, "int8-block", False),
)
ONE_A_RANK = ("tree-fedlay", "tree-ring", "flat-fedlay", "masked-flat",
              "codec-int8-block", "masked-codec-int4-block")
CASES = {layout: tuple(c for c in FULL_CASES
                       if layout[2] == 8 or c[0] in ONE_A_RANK)
         for layout in LAYOUTS}
PARAMS = [pytest.param(layout, case, id=f"w{layout[0]}g{layout[1]}-{case[0]}")
          for layout in LAYOUTS for case in CASES[layout]]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(C, L):
    """The layout's seeded inputs: a tree of two f32 leaves of ragged
    widths (35 and 33 columns, each padded to 128 in the flat row), a
    small residual over the flat row, a mask with client 0 dead, and the
    schedule, its weights redrawn at random (rows summing to 1, the
    pruned edges kept at 0) so that a row received from the wrong source
    or into the wrong slot changes the result."""
    rng = np.random.default_rng(C * 10 + L)
    sched = tm.build_permute_schedule(C, L, salt=SALT)
    w = sched.weights * rng.uniform(0.5, 1.5, sched.weights.shape)
    self_w = rng.uniform(0.5, 1.5, C)
    total = self_w + w.sum(axis=1)
    sched = tm.PermuteSchedule(C, L, sched.perms, (w / total[:, None]).astype(np.float32),
                               (self_w / total).astype(np.float32))
    X = {"a": rng.normal(size=(C, 5, 7)).astype(np.float32),
         "b": (rng.normal(size=(C, 33)) * 3.0).astype(np.float32)}
    N = FlatSpec.for_tree({k: torch.from_numpy(v) for k, v in X.items()}).size
    R = (rng.normal(size=(C, N)) * 0.01).astype(np.float32)
    mask = (rng.random(C) > 0.3).astype(np.float32)
    mask[0], mask[-1] = 0.0, 1.0
    return X, R, mask, sched


def _ef(codec):
    return codec is not None and get_codec(codec).error_feedback


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _run_cases(mesh, G, C, L, cases, sent):
    """Every case on this rank's rows; returns its outputs by key."""
    X, R, mask, sched = _inputs(C, L)
    rows = slice(mesh.rank * G, (mesh.rank + 1) * G)
    tree = {k: torch.from_numpy(v[rows].copy()) for k, v in X.items()}
    w, s = sched.weights[rows], sched.self_weight[rows]
    res = {}
    for name, entry, strategy, fuse, codec, masked in cases:
        sent[0] = 0
        r = torch.from_numpy(R[rows].copy())
        ef = _ef(codec)
        if entry == "make":
            mixer = make_mixer(strategy, sched, mesh.group, C, clients_per_device=G,
                               fuse=fuse, codec=codec)
            got = mixer(tree, w, s, r) if ef else mixer(tree, w, s)
        else:
            got = fedlay_mix(tree, sched, w, s, mesh.group, mask=mask[rows], fuse=fuse,
                             codec=codec, residual=r if ef else None)
        if ef:
            got, r_out = got
            res[f"{name}/res"] = r_out.numpy()
            res[f"{name}/res_is_input"] = np.bool_(r_out is r)
        for k, v in got.items():
            res[f"{name}/{k}"] = v.numpy()
        res[f"{name}/sent"] = np.int64(sent[0])
    # the layout check: a schedule for other than G x world clients
    try:
        fedlay_mix(tree, tm.build_permute_schedule(C + G, L), np.zeros((G, 2 * L)),
                   np.ones(G), mesh.group)
        res["layout_check"] = np.bool_(False)
    except ValueError:
        res["layout_check"] = np.bool_(True)
    return res


def _swap_under_barrier(mesh, G, C):
    """A shard_map-kind controller whose swap barrier is gloo's
    monitored_barrier: a fail and a join stage a swap, the barrier passes
    on every rank, the swap goes live, and the new mixer's int8-block
    round on this rank's rows equals the port's global round's rows."""
    sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                    probe_period=1.0, seed=0)
    sim.seed_network(list(range(C)))
    ctl = OverlayController(
        sim, mixer_kind="shard_map", group=mesh.group, clients_per_device=G,
        codec="int8-block", double_buffered=True,
        swap_barrier=lambda: dist.monitored_barrier(
            mesh.group, timeout=datetime.timedelta(seconds=INIT_S)))
    before = ctl.schedule
    ctl.step(3.0, trace=ChurnTrace.scripted([(0.5, "fail", 3), (0.5, "join", 70, 0)]))
    staged = ctl.schedule == before
    ctl.commit()
    X, R, _, _ = _inputs(C, 2)
    sched = ctl.schedule
    rows = slice(mesh.rank * G, (mesh.rank + 1) * G)
    tree = {k: torch.from_numpy(v[rows].copy()) for k, v in X.items()}
    got, _ = ctl.mixer(tree, sched.weights[rows], sched.self_weight[rows],
                       torch.from_numpy(R[rows].copy()))
    want, _ = global_mixer("fedlay", sched, codec="int8-block")(
        {k: torch.from_numpy(v) for k, v in X.items()}, torch.from_numpy(R.copy()))
    err = max(float((got[k] - want[k][rows]).abs().max()) for k in X)
    return {"swap/staged": np.bool_(staged),
            "swap/live": np.bool_(ctl.schedule != before and 70 in ctl.alive
                                  and 3 not in ctl.alive),
            "swap/aborts": np.int64(ctl.swap_barrier_aborts),
            "swap/err": np.float64(err),
            "swap/scale": np.float64(max(np.abs(v).max() for v in X.values()))}


def _rank_main(rank, world, G, C, L, cases, out_dir):
    out = pathlib.Path(out_dir)
    try:
        torch.set_num_threads(1)
        mesh = make_client_mesh(rank, world, f"file://{out / 'store'}", device="cpu",
                                timeout_s=INIT_S)
        sent = [0]
        exchange = sync._exchange

        def counting(ops):
            sent[0] += sum(op.tensor.numel() for op in ops if op.op is dist.isend)
            exchange(ops)
        sync._exchange = counting
        res = _run_cases(mesh, G, C, L, cases, sent)
        if world == 2:
            res.update(_swap_under_barrier(mesh, G, C))
        np.savez(out / f"rank{rank}.npz", **res)
        mesh.close()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every layout's ranks, spawned together, and while they run the
    reference's programs.  Returns (port, jax): per layout the outputs of
    every case with the ranks' rows in client order and each rank's
    results; per layout the reference's outputs."""
    import jax
    if jax.device_count() < 8:
        pytest.skip(f"needs >= 8 host devices, have {jax.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    procs, dirs = [], {}
    for layout in LAYOUTS:
        world, G, C, L = layout
        d = dirs[layout] = tmp_path_factory.mktemp(f"w{world}g{G}")
        for rank in range(world):
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(rank, world, G, C, L, CASES[layout], str(d)))
            p.start()
            procs.append(p)
    deadline = time.monotonic() + JOIN_S
    try:
        ref = {layout: _jax_layout(layout) for layout in LAYOUTS}
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errors = [f.read_text() for d in dirs.values() for f in sorted(d.glob("*.err"))]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        pytest.fail(f"{len(hung)} ranks still running after {JOIN_S} s; exit codes "
                    f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    port = {}
    for layout, d in dirs.items():
        ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(layout[0])]
        port[layout] = {
            "ranks": ranks,
            "rows": {k: np.concatenate([r[k] for r in ranks]) for k in ranks[0]
                     if ranks[0][k].ndim > 0}}
    return port, ref


# --------------------------------------------------------------------------
# the references on the same inputs
# --------------------------------------------------------------------------

def _jax_layout(layout):
    """The reference's shard_map program of every case of a layout, one
    program on ``world`` devices of the 8-device CPU mesh, G a device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.mixing import PermuteSchedule as JPermuteSchedule
    from repro.dist.compat import make_client_mesh as j_mesh, shard_map
    from repro.dist.sync import fedlay_mix as j_fedlay_mix, make_mixer as j_make_mixer

    world, G, C, L = layout
    X, R, mask, tsched = _inputs(C, L)
    sched = JPermuteSchedule(C, L, tsched.perms, tsched.weights, tsched.self_weight)

    def body(a, b, w, s, m, r):
        tree, outs = {"a": a, "b": b}, {}
        for name, entry, strategy, fuse, codec, masked in CASES[layout]:
            ef = _ef(codec)
            if entry == "make":
                mixer = j_make_mixer(strategy, sched, "data", C, clients_per_device=G,
                                     fuse=fuse, codec=codec)
                got = mixer(tree, w, s, r) if ef else mixer(tree, w, s)
            else:
                got = j_fedlay_mix(tree, sched, w, s, "data", mask=m, fuse=fuse,
                                   codec=codec, residual=r if ef else None)
            if ef:
                got, outs[f"{name}/res"] = got
            outs.update({f"{name}/{k}": v for k, v in got.items()})
        return outs

    mesh = j_mesh(world, "data")
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 6,
                          out_specs=P("data"), check_vma=False))
    shard = NamedSharding(mesh, P("data"))
    args = (X["a"], X["b"], sched.weights, sched.self_weight, mask, R)
    outs = f(*[jax.device_put(jnp.asarray(a), shard) for a in args])
    return {k: np.asarray(v) for k, v in outs.items()}


def _port_global(layout, case):
    """The same case through the port's global_mixer over all C clients:
    (outputs by leaf, residual or None)."""
    world, G, C, L = layout
    name, entry, strategy, fuse, codec, masked = case
    X, R, mask, sched = _inputs(C, L)
    tree = {k: torch.from_numpy(v) for k, v in X.items()}
    gsched = {"fedlay": sched, "ring": ring_schedule(C)}.get(strategy)
    mixer = global_mixer(strategy, gsched, masked=masked, fuse=fuse, codec=codec)
    args = (tree,) + ((mask,) if masked else ()) + (
        (torch.from_numpy(R.copy()),) if _ef(codec) else ())
    got = mixer(*args)
    got, res = got if _ef(codec) else (got, None)
    return {k: v.numpy() for k, v in got.items()}, None if res is None else res.numpy()


# --------------------------------------------------------------------------
# the per-rank mixer against the references
# --------------------------------------------------------------------------

@pytest.mark.multi_device
@pytest.mark.parametrize("layout,case", PARAMS)
def test_per_rank_mixer_matches_jax_and_global(runs, layout, case):
    """The ranks' rows against the reference's shard_map program at the
    same layout and the port's global_mixer.  Mixed outputs within 1e-6 x max|X| (f32 sums of
    at most 2L+1 terms of rows that sum to 1; the port's global codec
    round adds the self term after the neighbours, the per-rank round
    before, and allreduce sums across ranks in another order); the
    error-feedback residual bit for bit (both sides quantize, or take the
    top k of, the same f32 operand buf + residual) and updated in place;
    masked-out clients keep their rows and their residual bit for bit."""
    world, G, C, L = layout
    name, entry, strategy, fuse, codec, masked = case
    X, R, mask, _ = _inputs(C, L)
    port, ref = runs
    rows, ref = port[layout]["rows"], ref[layout]
    want_global, res_global = _port_global(layout, case)
    atol = 1e-6 * max(np.abs(v).max() for v in X.values())
    for leaf in X:
        got = rows[f"{name}/{leaf}"]
        np.testing.assert_allclose(got, ref[f"{name}/{leaf}"], rtol=0, atol=atol)
        np.testing.assert_allclose(got, want_global[leaf], rtol=0, atol=atol)
        if masked:
            np.testing.assert_array_equal(got[mask == 0], X[leaf][mask == 0])
        if strategy == "none":
            np.testing.assert_array_equal(got, X[leaf])
    if _ef(codec):
        res = rows[f"{name}/res"]
        np.testing.assert_array_equal(res, ref[f"{name}/res"])
        np.testing.assert_array_equal(res, res_global)
        assert all(r[f"{name}/res_is_input"] for r in port[layout]["ranks"])
        if masked:
            np.testing.assert_array_equal(res[mask == 0], R[mask == 0])


def _row_bytes(name, codec, N, leaves):
    """Bytes one client's row puts on the wire in one exchange: the
    codec's wire image of the flat row, the raw f32 flat row, or the
    tree walk's leaves (unpadded: the walk sends each leaf as it is)."""
    if codec is not None:
        return get_codec(codec).wire_bytes(N)
    if name.startswith("flat") or name == "masked-flat":
        return 4 * N
    return 4 * sum(v[0].size for v in leaves.values())


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"w{l[0]}g{l[1]}")
def test_bytes_sent_match_the_routing_and_sync_bytes(runs, layout):
    """Each rank's bytes sent in one round, counted at the sends, against
    the routing and the closed forms of sync_bytes_per_client.

    * fedlay: each cross-rank edge of weight > 0 whose source the rank
      holds sends one row (one row a slot with one client a rank, as the
      reference's one ppermute a slot), and a masked round also the
      source's 4-byte mask entry.  The closed form is an expectation over
      schedules ((K − G)/(K − 1) of min(2L, K − 1) neighbours), exact with
      one rank (0) and with one client a rank when n − 1 ≥ 2L (2L rows);
    * ring: exactly sync_bytes_per_client × G (2 rows a rank across
      ranks, 0 with one rank);
    * allreduce and none send nothing point to point.
    Row bytes are the codec's wire_bytes of the lane-padded flat width
    N; the tree walk sends each leaf unpadded."""
    world, G, C, L = layout
    X, _, _, sched = _inputs(C, L)
    N = FlatSpec.for_tree({k: torch.from_numpy(v) for k, v in X.items()}).size
    rt = tm.grouped_routing(sched, G)
    for name, entry, strategy, fuse, codec, masked in CASES[layout]:
        row = _row_bytes(name, codec, N, X)
        for rank, got in enumerate(r[f"{name}/sent"] for r in runs[0][layout]["ranks"]):
            if strategy in ("allreduce", "none"):
                assert got == 0, name
                continue
            if strategy == "ring":
                want = sync_bytes_per_client("ring", row, C, clients_per_device=G,
                                             codec=None) * G
                assert got == want, (name, rank, got, want)
                continue
            if G == 1:
                edges = sum(sched.perms[k].index(rank) != rank
                            for k in range(sched.num_slots))
                assert edges == sync_bytes_per_client("fedlay", 1, C, L)
            else:
                edges = sum(1 for slot in rt.rounds for rnd in slot
                            for s, _ in rnd.pairs if s == rank)
            assert got == edges * (row + 4 * masked), (name, rank, got, edges)
            if world == 1:
                assert got == sync_bytes_per_client("fedlay", 4 * N, C, L,
                                                    clients_per_device=G, codec=codec) == 0


def test_layout_check_and_swap_barrier_in_the_ranks(runs):
    """A schedule for other than G x world clients raises on every rank;
    under gloo's monitored_barrier a staged swap of the shard_map kind
    goes live on both ranks of the world-2 group, and the new mixer's
    int8-block round equals the port's global round within
    1e-6 x max|X| (the self term's place in the sum differs)."""
    for layout, run in runs[0].items():
        assert all(r["layout_check"] for r in run["ranks"]), layout
    for r in runs[0][(2, 4, 8, 2)]["ranks"]:
        assert r["swap/staged"] and r["swap/live"] and r["swap/aborts"] == 0
        assert r["swap/err"] <= 1e-6 * r["swap/scale"]


# --------------------------------------------------------------------------
# in this process: no group, the controller's checks, the mesh helpers
# --------------------------------------------------------------------------

def test_mixers_raise_without_a_process_group():
    """A per-rank mixer called with no initialized process group raises;
    world size 1 is a real group, not a mode of its own."""
    assert not dist.is_initialized()
    sched = tm.build_permute_schedule(4, 1)
    tree = {"a": torch.zeros((4, 3))}
    for strategy in ("fedlay", "ring", "allreduce"):
        mixer = make_mixer(strategy, sched, None, 4, clients_per_device=4)
        with pytest.raises(RuntimeError, match="process group"):
            mixer(tree, sched.weights, sched.self_weight)
    with pytest.raises(ValueError, match="divide"):
        make_mixer("fedlay", sched, None, 4, clients_per_device=3)
    with pytest.raises(ValueError, match="schedule is for"):
        make_mixer("fedlay", sched, None, 8, clients_per_device=4)
    with pytest.raises(ValueError, match="error feedback"):
        fedlay_mix(tree, sched, sched.weights, sched.self_weight, codec="int8-block")
    with pytest.raises(ValueError, match="flat path"):
        fedlay_mix(tree, sched, sched.weights, sched.self_weight, out=torch.zeros(4, 128))


def _controller_sim(n=8):
    sim = Simulator(num_spaces=2, latency=0.05, heartbeat_period=0.5,
                    probe_period=1.0, seed=0)
    sim.seed_network(list(range(n)))
    return sim


def test_controller_shard_map_kind_checks():
    """The reference's checks (controller.py:284-302): an unknown kind, a
    capacity that is not a multiple of G, capacity mode with the
    shard_map kind and flat_io with it raise; the shard_map kind builds
    make_mixer's per-rank mixers, keyed by schedule like the global
    kind's."""
    with pytest.raises(ValueError, match="mixer kind"):
        OverlayController(_controller_sim(), mixer_kind="pmap")
    with pytest.raises(ValueError, match="multiple"):
        OverlayController(_controller_sim(), capacity=10, clients_per_device=4)
    with pytest.raises(ValueError, match="capacity mode"):
        OverlayController(_controller_sim(), mixer_kind="shard_map", capacity=8)
    with pytest.raises(ValueError, match="flat_io"):
        OverlayController(_controller_sim(), mixer_kind="shard_map", fuse="flat",
                          flat_io=True)
    with pytest.raises(ValueError, match=">= 1"):
        OverlayController(_controller_sim(), clients_per_device=0)
    ctl = OverlayController(_controller_sim(), mixer_kind="shard_map",
                            clients_per_device=4, codec="int8-block")
    assert ctl.clients_per_device == 4 and ctl.schedule.num_clients == 8
    tree = {"a": torch.zeros((4, 3))}
    with pytest.raises(RuntimeError, match="process group"):
        ctl.mixer(tree, ctl.schedule.weights[:4], ctl.schedule.self_weight[:4],
                  torch.zeros((4, 128)))


def test_swap_barrier_abort_keeps_the_swap_staged():
    """A raising swap barrier keeps the staged swap staged and the live
    mixer serving, counts an abort (and faults.swap_barrier_aborts); the
    next commit whose barrier passes makes the swap live."""
    from repro_torch.obs.events import telemetry
    calls, armed = [], []

    def barrier():
        calls.append(1)
        if armed:
            armed.pop()
            raise TimeoutError("a peer missed the boundary")

    ctl = OverlayController(_controller_sim(), double_buffered=True,
                            swap_barrier=barrier)
    live, mixer = ctl.schedule, ctl.mixer
    ctl.step(3.0, trace=ChurnTrace.scripted([(0.5, "fail", 3), (0.5, "join", 70, 0)]))
    assert ctl.schedule is live
    before = len(calls)
    armed.append(True)
    with telemetry() as bus:
        ctl.commit()
        assert bus.counters.get("faults.swap_barrier_aborts") == 1
    assert ctl.swap_barrier_aborts == 1 and ctl.last_commit_ms == 0.0
    assert ctl.schedule is live and ctl.mixer is mixer and ctl._staged is not None
    ctl.commit()
    assert len(calls) == before + 2 and ctl.swap_barrier_aborts == 1
    assert ctl.schedule != live and 70 in ctl.alive and 3 not in ctl.alive


def test_mesh_helpers_and_client_count():
    """data_axes, num_clients and dfl_client_count over a one-axis mesh
    (the reference's rules: G x the product of the non-model axes);
    asking for CUDA where there is none raises before any rendezvous."""
    mesh = ClientMesh(group=None, rank=1, size=4, device=torch.device("cpu"))
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4}
    assert data_axes(mesh) == ("data",) and num_clients(mesh) == 4
    assert dfl_client_count(mesh) == 4 and dfl_client_count(mesh, 3) == 12
    with pytest.raises(ValueError, match=">= 1"):
        dfl_client_count(mesh, 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_client_mesh(0, 1, "file:///nonexistent", device="cuda")


# --------------------------------------------------------------------------
# host side: the grouped routing against the reference's
# --------------------------------------------------------------------------

def _j():
    from repro.core import mixing as jm
    return jm


def _same_routing(rt, jrt):
    assert (rt.clients_per_device, rt.num_devices) == (jrt.clients_per_device,
                                                      jrt.num_devices)
    for a, b in zip(rt.intra_src + rt.intra_on, jrt.intra_src + jrt.intra_on):
        np.testing.assert_array_equal(a, b)
    assert len(rt.rounds) == len(jrt.rounds)
    for slot, jslot in zip(rt.rounds, jrt.rounds):
        assert len(slot) == len(jslot)
        for rnd, jrnd in zip(slot, jslot):
            assert rnd.pairs == jrnd.pairs
            for f in ("send_row", "recv_slot", "recv_on"):
                np.testing.assert_array_equal(getattr(rnd, f), getattr(jrnd, f))
    assert rt.cross_edges == jrt.cross_edges and rt.max_rounds == jrt.max_rounds


@pytest.mark.parametrize("G", (1, 2, 3, 4, 8))
def test_grouped_routing_matches_jax(G):
    """The same tables as the reference's for the same schedule, over six
    salts; every weighted edge covered once by an intra take or a valid
    round (unique sources and destinations), at most G rounds a slot."""
    jm = _j()
    n = 8 * G
    for salt in range(6):
        sched = tm.build_permute_schedule(n, 3, salt=f"koenig{salt}")
        jsched = jm.build_permute_schedule(n, 3, salt=f"koenig{salt}")
        assert sched.perms == jsched.perms
        rt = tm.grouped_routing(sched, G)
        _same_routing(rt, jm.grouped_routing(jsched, G))
        covered = set()
        for k in range(sched.num_slots):
            for d in range(8):
                for l in range(G):
                    if rt.intra_on[k][d, l] > 0:
                        covered.add((d * G + l, k))
            assert len(rt.rounds[k]) <= G
            for rnd in rt.rounds[k]:
                srcs = [p[0] for p in rnd.pairs]
                dsts = [p[1] for p in rnd.pairs]
                assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts)
                for sd, dd in rnd.pairs:
                    i = dd * G + rnd.recv_slot[dd]
                    assert sd * G + rnd.send_row[sd] == sched.perms[k][i]
                    assert (i, k) not in covered
                    covered.add((i, k))
        assert covered == {(i, k) for i in range(n) for k in range(sched.num_slots)
                           if sched.weights[i, k] > 0}


def test_grouped_routing_edge_cases_match_jax():
    """One rank: all intra takes; G = 1: one round a slot; a bad group
    raises as the reference's does; the tables are read-only."""
    jm = _j()
    rt = tm.grouped_routing(tm.build_permute_schedule(6, 2), 6)
    assert rt.cross_edges == 0 and rt.max_rounds == 0
    _same_routing(rt, jm.grouped_routing(jm.build_permute_schedule(6, 2), 6))
    rt1 = tm.grouped_routing(tm.build_permute_schedule(8, 3, salt="g1"), 1)
    assert rt1.max_rounds <= 1
    _same_routing(rt1, jm.grouped_routing(jm.build_permute_schedule(8, 3, salt="g1"), 1))
    sched = tm.build_permute_schedule(8, 2)
    with pytest.raises(ValueError, match="divide"):
        tm.grouped_routing(sched, 3)
    with pytest.raises(ValueError, match=">= 1"):
        tm.grouped_routing(sched, 0)
    with pytest.raises(ValueError, match="read-only"):
        tm.grouped_routing(sched, 2).intra_src[0][0, 0] = 1


def test_bipartite_edge_coloring_matches_jax():
    """The Kempe-chain colorer gives the reference's colors, proper and
    with at most Δ of them, multigraph edges included."""
    jm = _j()
    rng = np.random.default_rng(0)
    for _ in range(50):
        D = int(rng.integers(2, 9))
        edges = [(int(rng.integers(D)), int(rng.integers(D)))
                 for _ in range(int(rng.integers(1, 3 * D)))]
        colors = tm._bipartite_edge_coloring(edges, D)
        assert colors == jm._bipartite_edge_coloring(edges, D)
        deg = {}
        for s, d in edges:
            deg[("s", s)] = deg.get(("s", s), 0) + 1
            deg[("d", d)] = deg.get(("d", d), 0) + 1
        assert max(colors) + 1 <= max(deg.values())
        seen = set()
        for (s, d), c in zip(edges, colors):
            assert (c, "s", s) not in seen and (c, "d", d) not in seen
            seen |= {(c, "s", s), (c, "d", d)}
    assert tm._bipartite_edge_coloring([], 4) == []


@pytest.mark.parametrize("G", (1, 2, 4))
@pytest.mark.parametrize("masked", (False, True))
def test_grouped_mix_reference_matches_jax_and_dense(G, masked):
    """The numpy oracle: the reference's result bit for bit (the same
    float64 operations in the same order) and the dense masked matrix
    within 1e-12 (float64, another order)."""
    jm = _j()
    n = 8 * G
    sched = tm.build_permute_schedule(n, 2, salt=f"ref{G}")
    rng = np.random.default_rng(G)
    X = rng.normal(size=(n, 5))
    mask = (rng.random(n) > 0.3).astype(np.float64) if masked else None
    got = tm.grouped_mix_reference(sched, X, G, mask=mask)
    np.testing.assert_array_equal(got, jm.grouped_mix_reference(
        jm.build_permute_schedule(n, 2, salt=f"ref{G}"), X, G, mask=mask))
    W = tm.masked_mixing_matrix(sched, np.ones(n) if mask is None else mask)
    np.testing.assert_allclose(got, W @ X, rtol=0, atol=1e-12)


def test_grouped_mix_reference_on_padded_schedule():
    """Dead capacity slots (weight-0 self-loops) never touch the wire and
    pass through the decomposition, as in the reference."""
    jm = _j()
    padded = tm.pad_schedule(tm.build_permute_schedule(6, 2), (0, 1, 2, 4, 5, 7), 8)
    jpadded = jm.pad_schedule(jm.build_permute_schedule(6, 2), (0, 1, 2, 4, 5, 7), 8)
    mask = np.zeros(8)
    mask[[0, 1, 2, 4, 5, 7]] = 1
    X = np.random.default_rng(0).normal(size=(8, 4))
    for G in (1, 2, 4):
        got = tm.grouped_mix_reference(padded, X, G, mask=mask)
        np.testing.assert_array_equal(got, jm.grouped_mix_reference(jpadded, X, G,
                                                                    mask=mask))
        np.testing.assert_allclose(got, tm.masked_mixing_matrix(padded, mask) @ X,
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("pods,spaces", [(2, None), (4, None), (4, 2), (8, 1)])
def test_pod_bias_schedules_and_cross_pod_messages_match_jax(pods, spaces):
    """pod_bias schedules equal the reference's (perms and weights), and
    cross_pod_messages counts the same: exactly P crossing edges a biased
    ring and direction, fewer than the unbiased schedule's."""
    jm = _j()
    n, L = 32, 3
    sched = tm.build_permute_schedule(n, L, pod_bias=pods, pod_bias_spaces=spaces)
    jsched = jm.build_permute_schedule(n, L, pod_bias=pods, pod_bias_spaces=spaces)
    assert sched == tm.PermuteSchedule(n, L, jsched.perms, jsched.weights,
                                       jsched.self_weight)
    got = tm.cross_pod_messages(sched, pods)
    assert got == jm.cross_pod_messages(jsched, pods)
    biased = L if spaces is None else spaces
    per_space = [sum(src // (n // pods) != dst // (n // pods)
                     for dst, src in enumerate(sched.perms[k]))
                 for k in range(2 * L)]
    assert per_space[:2 * biased] == [pods] * (2 * biased)
    assert got < tm.cross_pod_messages(tm.build_permute_schedule(n, L), pods)
    with pytest.raises(ValueError, match="pods"):
        tm.build_permute_schedule(10, 2, pod_bias=4)
