"""The port's training front door against the JAX reference on the CPU:
``launch/train.py``'s ``make_dfl_step`` and ``run`` (one rank, two gloo
ranks, crash and resume, checkpoints crossing between the packages),
``launch/steps.py:dfl_train_bundle``, and the CLI.

Same numpy inputs and parameters on both sides (the reference's initial
parameters carried over with ``tree_from_numpy``, the same
``TokenStream`` batches); each tolerance is stated where it is used.
The reference's compiles are shared through module-scoped fixtures.

The spawned ranks of the two-rank run import this module, so JAX and
the reference package are imported only inside the functions that run
the reference.
"""

import argparse
import json
import multiprocessing
import os
import pathlib
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import load
from repro_torch.core.mixing import build_permute_schedule
from repro_torch.data.tokens import TokenStream
from repro_torch.dist.flat import tree_flatten, tree_map
from repro_torch.dist.sync import make_mixer, resolve_wire
from repro_torch.launch import train
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.models.convert import tree_from_numpy
from repro_torch.optim.optimizers import adamw

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Seconds a rank waits on the group, and seconds the test waits for the
#: two ranks to finish.
INIT_S, JOIN_S = 60, 240
C, L, STEPS, VOCAB, BATCH, SEQ, LR = 4, 2, 3, 128, 2, 16, 3e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo client group for the module's in-process runs."""
    store = tmp_path_factory.mktemp("store") / "store"
    m = make_client_mesh(0, 1, f"file://{store}", device="cpu", timeout_s=INIT_S)
    yield m
    m.close()


def _cfg(layers=1):
    return train.tiny_lm(vocab=VOCAB, d_model=64, layers=layers)


def _j_params(layers=1):
    """The reference's initial parameters of ``_cfg`` as numpy."""
    import jax
    from repro.launch.train import tiny_lm as j_tiny_lm
    from repro.models.model import init_params as j_init_params
    p = j_init_params(j_tiny_lm(vocab=VOCAB, d_model=64, layers=layers),
                      jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _batches(steps, clients=range(C), seq=SEQ):
    """``steps`` stacked (C, B, S) batches from each client's stream."""
    streams = [iter(TokenStream(VOCAB, BATCH, seq, seed=0, client=c)) for c in clients]
    out = []
    for _ in range(steps):
        xs, ys = zip(*(next(s) for s in streams))
        out.append({"tokens": np.stack(xs), "labels": np.stack(ys)})
    return out


def test_tiny_lm_is_the_configs_object():
    from repro_torch import configs
    assert train.tiny_lm is configs.tiny_lm


# --------------------------------------------------------------------------
# make_dfl_step, one rank holding every client, against the reference's
# --------------------------------------------------------------------------

#: (sync, fuse, codec): the tree walk, the flat path and the block
#: codecs of fedlay, then the baselines.
STEP_CASES = (("fedlay", None, None), ("fedlay", "flat", None),
              ("fedlay", None, "int8-block"), ("fedlay", None, "int4-block"),
              ("allreduce", None, None), ("ring", None, None), ("none", None, None))


def _step_id(case):
    return "-".join(c for c in case if c)


@pytest.fixture(scope="module")
def j_steps():
    """The reference's make_dfl_step on one device, C clients on it, for
    every case: its losses and final parameters over STEPS steps."""
    import jax
    import jax.numpy as jnp
    from repro.core.mixing import build_permute_schedule as j_sched
    from repro.dist.compat import make_client_mesh as j_mesh
    from repro.dist.flat import FlatSpec as JFlatSpec
    from repro.dist.sync import make_mixer as j_make_mixer
    from repro.dist.sync import resolve_wire as j_resolve_wire
    from repro.launch.train import make_dfl_step as j_make_dfl_step
    from repro.launch.train import tiny_lm as j_tiny_lm
    from repro.optim.optimizers import adamw as j_adamw

    cfg = j_tiny_lm(vocab=VOCAB, d_model=64, layers=1)
    p0 = jax.tree.map(jnp.asarray, _j_params())
    opt = j_adamw(LR, weight_decay=0.0)
    stack = lambda t: jax.tree.map(lambda x: jnp.broadcast_to(x[None], (C,) + x.shape), t)
    mesh = j_mesh(1, "data")
    sched = j_sched(C, L)
    batches = _batches(STEPS)
    out = {}
    for sync, fuse, codec in STEP_CASES:
        wire, _ = j_resolve_wire(codec, fuse)
        ef = wire is not None and wire.error_feedback and sync in ("fedlay", "ring")
        mixer = j_make_mixer(sync, sched, "data", C, clients_per_device=C, fuse=fuse,
                             codec=codec)
        step = j_make_dfl_step(cfg, opt, mixer, mesh, error_feedback=ef)
        params, o = stack(p0), stack(opt.init(p0))
        res = jnp.zeros((C, JFlatSpec.for_tree(params).size)) if ef else None
        losses = []
        for b in batches:
            args = (params, o, {k: jnp.asarray(v) for k, v in b.items()},
                    jnp.asarray(sched.weights), jnp.asarray(sched.self_weight))
            if ef:
                params, o, res, loss = step(*args, res)
            else:
                params, o, loss = step(*args)
            losses.append(float(loss))
        out[(sync, fuse, codec)] = (losses, jax.tree.map(np.asarray, params),
                                    None if res is None else np.asarray(res))
    return out


def _t_run_steps(mesh, sync, fuse, codec, steps=STEPS):
    """The port's make_dfl_step on the one-rank group, G = C: losses,
    the final parameter tree, the state and the buffers' data_ptr before
    the first step."""
    cfg = _cfg()
    p0 = tree_from_numpy(_j_params())
    opt = adamw(LR, weight_decay=0.0)
    wire, fuse_n = resolve_wire(codec, fuse)
    mixing = sync in ("fedlay", "ring")
    ef = wire is not None and wire.error_feedback and mixing
    state = train.rank_state(p0, C, opt, flat=mixing and fuse_n == "flat", codec=wire,
                             error_feedback=ef)
    ptrs = state.buffers()
    sched = build_permute_schedule(C, L)
    mixer = make_mixer(sync, sched, mesh.group, C, clients_per_device=C, fuse=fuse,
                       codec=codec)
    step = train.make_dfl_step(cfg, opt, mixer, mesh.group, error_feedback=ef)
    w, s = torch.from_numpy(sched.weights), torch.from_numpy(sched.self_weight)
    losses = [float(step(state, {k: torch.from_numpy(v) for k, v in b.items()}, w, s))
              for b in _batches(steps)]
    return losses, state, ptrs


def _assert_round_close(got, want, atol, bound):
    """Within ``atol``, but for up to 1e-3 of the elements, which are
    within ``bound``: AdamW normalizes each gradient component by its own
    size, so where a component is near 0 (a cancelling sum) its f32
    rounding in the two autodiff systems can move its update by up to
    2 lr a step; under a block codec an operand within rounding of a
    quantization boundary rounds to either side, one step (at most
    max|p| / levels) apart."""
    diff = np.abs(got - want)
    off = diff > atol
    assert off.mean() <= 1e-3, (int(off.sum()), off.size, float(diff.max()))
    assert not off.any() or diff[off].max() <= bound, (float(diff.max()), bound)


@pytest.mark.parametrize("case", STEP_CASES, ids=_step_id)
def test_make_dfl_step_matches_jax(mesh, j_steps, case):
    """Three AdamW(3e-3) steps of tiny_lm (1 layer) on 4 clients: each
    step's loss within 1e-5 relative; the final parameters within
    2e-5 x max|p| (f32 gradients through two autodiff systems) but for
    at most 1e-3 of the elements, which are within 2 lr a step plus,
    under a block codec, one quantization step (``_assert_round_close``);
    the error-feedback residual held the same way.  The resident buffers
    keep their storage, and AdamW's count is the steps taken."""
    import jax
    from repro_torch.wire.codec import get_codec
    want_losses, want_params, want_res = j_steps[case]
    losses, state, ptrs = _t_run_steps(mesh, *case)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    scale = max(np.abs(l).max() for l in tree_flatten(want_params)[0])
    codec = get_codec(case[2])
    bound = 2 * LR * STEPS + (0.0 if codec is None else scale / codec.levels)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(want_params),
                                 tree_flatten(state.tree())[0]):
        _assert_round_close(got.numpy(), want, 2e-5 * scale, bound)
    if want_res is not None:
        _assert_round_close(state.residual.numpy(), want_res, 2e-5 * scale, bound)
    assert state.buffers() == ptrs
    assert state.opt_state["count"].tolist() == [STEPS] * C


# --------------------------------------------------------------------------
# run(args): two gloo ranks, resume, checkpoints across the packages
# --------------------------------------------------------------------------

RUN_STEPS, RUN_EVERY, RUN_G = 6, 3, 2


def _args(**kw):
    base = dict(device="cpu", clients=C, clients_per_device=RUN_G, steps=RUN_STEPS,
                sync="fedlay", fuse="flat", codec="int8-block", spaces=L, batch=BATCH,
                seq=SEQ, vocab=VOCAB, d_model=64, layers=1, lr=LR, seed=0,
                log_every=100, ckpt_dir=None, ckpt_every=RUN_EVERY, out=None,
                telemetry_out=None, profile_dir=None)
    base.update(kw)
    return argparse.Namespace(**base)


def _patch_init(params_npz):
    """The port's run starts from the reference's initial parameters."""
    with np.load(params_npz) as z:
        flat = {k: z[k] for k in z.files}

    def init(cfg, generator, **kw):
        tree = {}
        for key, value in flat.items():
            node = tree
            *parents, leaf = key.split("|")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(value.copy())
        return tree
    train.init_params = init


def _save_params(path):
    """The reference's initial parameters of tiny_lm at the run's size,
    as one npz keyed by their paths."""
    import jax
    params = _j_params()
    flat = {"|".join(k.key for k in p): v
            for p, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(path, **flat)


def _spy_p2p():
    """Record the element count of every tensor that ``dist.send`` and
    ``dist.recv`` move in this process (the checkpoint's transfers: the
    mixer's exchanges go through ``batch_isend_irecv``)."""
    import torch.distributed as dist
    moved = {"send": [], "recv": []}
    for name in moved:
        def spy(tensor, *a, _fn=getattr(dist, name), _name=name, **kw):
            moved[_name].append(tensor.numel())
            return _fn(tensor, *a, **kw)
        setattr(dist, name, spy)
    return moved


def _rank_main(rank, out_dir):
    out = pathlib.Path(out_dir)
    try:
        torch.set_num_threads(1)
        _patch_init(out / "params.npz")
        moved = _spy_p2p()
        m = make_client_mesh(rank, 2, f"file://{out / 'store'}", device="cpu",
                             timeout_s=INIT_S)
        res = train.run(_args(ckpt_dir=str(out / "ckpt"),
                              out=str(out / "result.json")), m)
        np.save(out / f"losses{rank}.npy", np.asarray(res["losses"]))
        (out / f"moved{rank}.json").write_text(json.dumps(moved))
        m.close()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _j_run(**kw):
    """The reference's run(args), on RUN_G clients a device."""
    from repro.launch.train import run as j_run
    return j_run(_args(**kw))


def _leaves(directory, step):
    return [t.numpy() for t in load(os.path.join(directory, f"ckpt_{step:08d}"))[0]["leaves"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh):
    """The two-rank port run (spawned gloo ranks) beside the reference's
    run on two devices, then on one rank: the port uninterrupted, the
    port stopped at step 3 and resumed, the port resumed from the
    reference's step-3 checkpoint, and the reference resumed from the
    port's."""
    import jax
    if jax.device_count() < 2:
        pytest.skip(f"needs >= 2 host devices, have {jax.device_count()}")
    d = tmp_path_factory.mktemp("runs")
    _save_params(d / "params.npz")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(d / "w2")), daemon=True)
             for r in range(2)]
    (d / "w2").mkdir()
    shutil.copy(d / "params.npz", d / "w2" / "params.npz")
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        ref = _j_run(ckpt_dir=str(d / "ref"))
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errors = [f.read_text() for f in sorted((d / "w2").glob("*.err"))]
    if hung or errors or any(p.exitcode != 0 for p in procs):
        pytest.fail(f"{len(hung)} ranks still running after {JOIN_S} s; exit codes "
                    f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))

    saved = train.init_params
    try:
        _patch_init(d / "params.npz")
        one = dict(clients_per_device=C)
        full = train.run(_args(ckpt_dir=str(d / "full"), **one), mesh)
        first = train.run(_args(ckpt_dir=str(d / "crash"), steps=RUN_EVERY, **one), mesh)
        resumed = train.run(_args(ckpt_dir=str(d / "crash"), **one), mesh)
        # the reference's step-3 checkpoint, resumed by the port
        (d / "from_ref").mkdir()
        for ext in (".json", ".npz"):
            shutil.copy(d / "ref" / f"ckpt_{RUN_EVERY:08d}{ext}", d / "from_ref")
        port_from_ref = train.run(_args(ckpt_dir=str(d / "from_ref"), **one), mesh)
    finally:
        train.init_params = saved
    # the port's step-3 checkpoint, resumed by the reference
    (d / "from_port").mkdir()
    for ext in (".json", ".npz"):
        shutil.copy(d / "crash" / f"ckpt_{RUN_EVERY:08d}{ext}", d / "from_port")
    ref_from_port = _j_run(ckpt_dir=str(d / "from_port"))
    return {"dir": d, "ref": ref, "w2": [np.load(d / "w2" / f"losses{r}.npy")
                                          for r in range(2)],
            "full": full, "first": first, "resumed": resumed,
            "port_from_ref": port_from_ref, "ref_from_port": ref_from_port}


def test_run_two_ranks_matches_jax(runs):
    """fedlay, flat, int8-block, 4 clients, 2 a rank on two gloo ranks
    against the reference on two devices: every step's loss within 1e-5
    relative (f32 gradients through two autodiff systems; the int8 wire
    quantizes the same operands); both ranks report the same losses;
    rank 0's --out holds the reference's keys and values.  The final
    checkpoints hold the same leaves in the same order (n clients each,
    AdamW's mu, nu and count, the parameters, the residual), AdamW's
    count exactly, the parameters as ``_assert_round_close`` holds them
    (the int8 wire's rounding flips: within 2e-5 x max|p| but for at most
    1e-3 of the elements, one quantization step off), mu and nu within
    2e-3 x max|leaf| (the gradients that follow such a flip), the
    residual within one quantization step (max|p| / 127)."""
    d, ref = runs["dir"], runs["ref"]
    np.testing.assert_array_equal(runs["w2"][0], runs["w2"][1])
    np.testing.assert_allclose(runs["w2"][0], ref["losses"], rtol=1e-5)
    result = json.loads((d / "w2" / "result.json").read_text())
    assert set(result) == set(ref)
    keys = ("sync", "clients", "clients_per_device", "steps", "codec", "start_step")
    assert {k: result[k] for k in keys} == {k: ref[k] for k in keys}
    got, want = _leaves(d / "w2" / "ckpt", RUN_STEPS), _leaves(d / "ref", RUN_STEPS)
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    P = (len(want) - 2) // 3
    mu_nu, count, params, res = want[:2 * P], want[2 * P], want[2 * P + 1:-1], want[-1]
    scale = max(np.abs(w).max() for w in params)
    np.testing.assert_array_equal(got[2 * P], count)
    for g, w in zip(got[:2 * P], mu_nu):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * np.abs(w).max())
    for g, w in zip(got[2 * P + 1:-1], params):
        _assert_round_close(g, w, 2e-5 * scale, scale / 127)
    np.testing.assert_allclose(got[-1], res, rtol=0, atol=scale / 127)


def test_run_checkpoint_moves_a_leaf_at_a_time(runs):
    """With two ranks a checkpoint reaches rank 0's host one leaf of one
    rank at a time: rank 1 sends each leaf's G rows once a checkpoint
    (2 checkpoints: steps 3 and 6) and receives nothing; rank 0 receives
    exactly those, into a buffer of one rank's rows of one leaf, and
    sends nothing.  So no rank holds the group's state, or its own state
    twice, on its card."""
    d = runs["dir"]
    got = [json.loads((d / "w2" / f"moved{r}.json").read_text()) for r in range(2)]
    leaves = _leaves(d / "w2" / "ckpt", RUN_STEPS)
    rows = [l.size // C * RUN_G for l in leaves]
    saves = RUN_STEPS // RUN_EVERY
    assert got[1] == {"send": rows * saves, "recv": []}
    assert got[0] == {"send": [], "recv": rows * saves}


def test_run_resume_is_bit_exact(runs):
    """The port stopped after step 3 and resumed from its checkpoint
    equals its uninterrupted run bit for bit: the losses of steps 3-5 and
    every leaf of the final checkpoint."""
    d = runs["dir"]
    assert runs["first"]["start_step"] == 0 and runs["resumed"]["start_step"] == RUN_EVERY
    assert runs["resumed"]["losses"] == runs["full"]["losses"][RUN_EVERY:]
    assert runs["first"]["losses"] == runs["full"]["losses"][:RUN_EVERY]
    for g, w in zip(_leaves(d / "crash", RUN_STEPS), _leaves(d / "full", RUN_STEPS)):
        np.testing.assert_array_equal(g, w)


def test_run_resumes_across_packages(runs):
    """The reference's step-3 checkpoint resumed by the port, and the
    port's resumed by the reference: each resumes at step 3, and its
    losses of steps 3-5 are within 1e-5 relative of the reference's
    uninterrupted run (the port's one-rank run against the reference's
    two devices: the same round, sums in another order)."""
    ref = runs["ref"]["losses"]
    for res in (runs["port_from_ref"], runs["ref_from_port"]):
        assert res["start_step"] == RUN_EVERY
        np.testing.assert_allclose(res["losses"], ref[RUN_EVERY:], rtol=1e-5)
    np.testing.assert_allclose(runs["full"]["losses"], ref, rtol=1e-5)


def test_run_checks_the_layout(mesh):
    """--clients must be a multiple of --clients-per-device, and the
    world size must be clients / G; --device must match the group's."""
    with pytest.raises(SystemExit, match="multiple"):
        train.run(_args(clients=5, clients_per_device=2), mesh)
    with pytest.raises(SystemExit, match="ranks"):
        train.run(_args(clients=4, clients_per_device=2), mesh)
    with pytest.raises(ValueError, match="device"):
        train.run(_args(device="cuda", clients_per_device=C), mesh)


# --------------------------------------------------------------------------
# dfl_train_bundle, C clients on one device
# --------------------------------------------------------------------------

#: (masked, fuse, codec): the unmasked flat round, the masked flat round,
#: and int8-block with its residual.
BUNDLE_CASES = ((False, "flat", None), (True, "flat", None), (False, None, "int8-block"))


def _bundle_id(case):
    return ("masked" if case[0] else "plain") + "-" + (case[2] or case[1])


def _bundle_run(pkg, case, steps=2):
    """dfl_train_bundle of ``pkg`` ("jax" or "port") over 2 steps of
    sgd(0.05, momentum=0.9) from the reference's parameters: the losses,
    the final parameters (numpy leaves in tree order) and the residual."""
    import dataclasses
    import jax
    masked, fuse, codec = case
    batches = _batches(steps)
    mask = np.array([1, 1, 0, 1], np.float32)
    if pkg == "jax":
        import jax.numpy as jnp
        from repro.dist.flat import FlatSpec as JFlatSpec
        from repro.launch.mesh import make_local_mesh
        from repro.launch.steps import dfl_train_bundle as j_bundle
        from repro.launch.train import tiny_lm as j_tiny_lm
        from repro.models.config import INPUT_SHAPES
        from repro.optim.optimizers import sgd as j_sgd
        opt = j_sgd(0.05, momentum=0.9)
        shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=C * BATCH,
                                    seq_len=SEQ)
        b = j_bundle(j_tiny_lm(vocab=VOCAB, d_model=64, layers=1), shape,
                     make_local_mesh(1, 1), opt, dtype=jnp.float32, num_spaces=L,
                     masked=masked, clients_per_device=C, fuse=fuse, codec=codec)
        step = jax.jit(b.step)
        p0 = jax.tree.map(jnp.asarray, _j_params())
        params = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (C,) + x.shape), p0)
        o = jax.vmap(opt.init)(params)
        res = jnp.zeros((C, JFlatSpec.for_tree(params).size)) if codec else None
        conv = lambda bt: {k: jnp.asarray(v) for k, v in bt.items()}
        extra = (jnp.asarray(mask),) if masked else ()
    else:
        from repro_torch.dist.flat import FlatSpec
        from repro_torch.launch.steps import dfl_train_bundle
        from repro_torch.models.config import INPUT_SHAPES
        from repro_torch.optim.optimizers import sgd
        opt = sgd(0.05, momentum=0.9)
        shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=C * BATCH,
                                    seq_len=SEQ)
        b = dfl_train_bundle(_cfg(), shape, C, opt, num_spaces=L, masked=masked,
                             fuse=fuse, codec=codec)
        step = b.step
        params = tree_map(lambda l: l.unsqueeze(0).repeat((C,) + (1,) * l.dim()),
                          tree_from_numpy(_j_params()))
        o = tree_map(lambda l: l.unsqueeze(0).repeat((C,) + (1,) * l.dim()),
                     opt.init(tree_map(lambda l: l[0], params)))
        res = torch.zeros((C, FlatSpec.for_tree(params).size)) if codec else None
        conv = lambda bt: {k: torch.from_numpy(v) for k, v in bt.items()}
        extra = (mask,) if masked else ()
    losses = []
    for bt in batches:
        out = step(params, o, conv(bt), *extra, *((res,) if codec else ()))
        params, o, metrics = out[:3]
        if codec:
            res = out[3]
        losses.append(float(metrics["loss"]))
        if masked:
            assert float(metrics["num_alive"]) == 3.0
    if pkg == "jax":
        leaves = [np.asarray(l) for l in jax.tree.leaves(params)]
    else:
        leaves = [l.numpy() for l in tree_flatten(params)[0]]
    return losses, leaves, None if res is None else np.asarray(res)


@pytest.mark.parametrize("case", BUNDLE_CASES, ids=_bundle_id)
def test_dfl_train_bundle_matches_jax(case):
    """Two sgd(0.05, momentum 0.9) steps of tiny_lm (1 layer) on 4
    clients, C on one device: the losses within 1e-5 relative, the
    parameters within 1e-5 x max|p| (f32 gradients through two autodiff
    systems; the mixing sums in another order) and the residual within
    1e-5 x max|p|; a masked-out client keeps its parameters bit for
    bit."""
    want = _bundle_run("jax", case)
    got = _bundle_run("port", case)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    scale = max(np.abs(l).max() for l in want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)
    if case[2]:
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5 * scale)
    if case[0]:
        p0 = tree_flatten(tree_from_numpy(_j_params()))[0]
        for g, p in zip(got[1], p0):
            np.testing.assert_array_equal(g[2], p.numpy())


def test_dfl_train_bundle_checks_its_arguments():
    import dataclasses
    from repro_torch.launch.steps import dfl_train_bundle
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.optim.optimizers import sgd
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=8, seq_len=SEQ)
    with pytest.raises(ValueError, match="unknown sync"):
        dfl_train_bundle(_cfg(), shape, C, sgd(0.1), sync="gossip")
    with pytest.raises(ValueError, match="divide"):
        dfl_train_bundle(_cfg(), shape, 3, sgd(0.1))
    with pytest.raises(ValueError, match="only applies"):
        dfl_train_bundle(_cfg(), shape, C, sgd(0.1), sync="allreduce",
                         sched=build_permute_schedule(C, L))
    b = dfl_train_bundle(_cfg(), shape, C, sgd(0.1), codec="int8-block")
    assert b.error_feedback and b.sched.num_clients == C


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def test_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` under a
    one-rank ``torchrun`` environment (the ``env://`` rendezvous) exits
    0, writes --out with the reference's keys and --telemetry-out with a
    row a step, and prints the loss."""
    import socket
    out, tel = tmp_path / "o.json", tmp_path / "t.jsonl"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--clients", "4", "--clients-per-device", "4", "--steps", "3",
         "--d-model", "64", "--layers", "1", "--batch", "2", "--seq", "16",
         "--fuse", "flat", "--telemetry-out", str(tel), "--out", str(out)],
        capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(out.read_text())
    assert set(res) == {"sync", "clients", "clients_per_device", "steps", "codec",
                        "start_step", "first_loss", "final_loss", "losses",
                        "telemetry"}
    assert res["clients"] == 4 and len(res["losses"]) == 3
    rows = [json.loads(line) for line in tel.read_text().splitlines()]
    assert [r["round"] for r in rows] == [0, 1, 2]
    assert all(r["loop"] == "train" and r["train.steps"] == 1 for r in rows)
    assert "loss " in proc.stdout and "->" in proc.stdout


def test_make_client_mesh_rendezvous_checks(monkeypatch):
    """Only env:// reads the rank and world size; without torchrun's
    environment it raises, naming what is missing."""
    with pytest.raises(ValueError, match="explicit rank"):
        make_client_mesh(0, None, "tcp://127.0.0.1:1", device="cpu")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        make_client_mesh(device="cpu")


def test_cli_without_cuda_raises():
    """Without --device cpu the run asks for CUDA, and raises where there
    is none, before it joins any group."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1"])
