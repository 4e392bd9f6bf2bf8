"""The port's ``ServeLoop`` against the JAX ``ServeLoop`` on the same
weights and requests, its zero-reallocation contract, its CLI, and the
rule that the port imports neither JAX nor the reference package."""

import ast
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import tiny_lm
from repro.models.model import init_params
from repro.obs.events import telemetry as j_telemetry
from repro.obs.rounds import round_ledger as j_round_ledger
from repro.runtime.serving import ServeLoop as JServeLoop
from repro_torch.configs import tiny_lm as t_tiny_lm
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.events import telemetry
from repro_torch.obs.rounds import round_ledger
from repro_torch.runtime.serving import ServeLoop

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = tiny_lm(layers=2)
PARAMS = init_params(CFG, jax.random.PRNGKey(0))
MODEL = params_from_jax(t_tiny_lm(layers=2), jax.tree.map(np.asarray, PARAMS))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _requests(seed, n, max_prompt=8, max_new=(2, 7), **kw):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, CFG.vocab_size,
                                     int(rng.integers(1, max_prompt + 1))),
                 max_new=int(rng.integers(*max_new)), **kw)
            for _ in range(n)]


def _serve(loop, requests, bus_cm, ledger_cm):
    with bus_cm() as bus, ledger_cm() as ledger:
        for r in requests:
            loop.submit(**r)
        loop.run()
    done = {r.rid: (r.tokens, r.evicted) for r in loop.completed}
    return done, bus.counters, [(row.num_alive, row.extra) for row in ledger.rows]


def _both(requests, capacity=3, cache_len=24, prompt_len=8, policy="continuous"):
    kw = dict(capacity=capacity, cache_len=cache_len, prompt_len=prompt_len,
              policy=policy)
    ref = _serve(JServeLoop(CFG, PARAMS, **kw), requests, j_telemetry,
                 j_round_ledger)
    port = _serve(ServeLoop(MODEL, **kw), requests, telemetry, round_ledger)
    return ref, port


def _assert_same(ref, port):
    (jdone, jcount, jrows), (tdone, tcount, trows) = ref, port
    assert tdone == jdone                           # greedy tokens identical
    assert {k: tcount.get(k) for k in jcount} == jcount
    assert tcount["serve.decode_steps"] <= tcount["serve.ticks"]
    assert [r[0] for r in trows] == [r[0] for r in jrows]


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_serve_loop_matches_jax(policy):
    ref, port = _both(_requests(7, 6), policy=policy)
    _assert_same(ref, port)
    assert len(port[0]) == 6


def test_forced_retirement_matches_jax():
    """A generation that would overflow cache_len is retired by the host
    guard at the same token as in the reference."""
    reqs = [dict(prompt=np.arange(8) % CFG.vocab_size, max_new=50)]
    ref, port = _both(reqs, capacity=1, cache_len=10)
    _assert_same(ref, port)
    assert len(port[0][0][0]) <= 3


def test_eviction_matches_jax():
    reqs = [dict(prompt=np.arange(4) % CFG.vocab_size, max_new=50, max_ticks=2),
            dict(prompt=np.arange(4) % CFG.vocab_size, max_new=3),
            dict(prompt=np.arange(5) % CFG.vocab_size, max_new=50,
                 deadline_s=0.0)]
    ref, port = _both(reqs, capacity=1)
    _assert_same(ref, port)
    assert port[0][0][1] and port[0][2][1] and not port[0][1][1]
    assert port[1]["serve.evictions"] == 2


def test_continuous_matches_solo():
    reqs = _requests(8, 6)
    batched = _serve(ServeLoop(MODEL, capacity=3, cache_len=24, prompt_len=8),
                     reqs, telemetry, round_ledger)[0]
    solo = _serve(ServeLoop(MODEL, capacity=1, cache_len=24, prompt_len=8),
                  reqs, telemetry, round_ledger)[0]
    assert batched == solo
    assert all(len(batched[i][0]) == r["max_new"] for i, r in enumerate(reqs))


def test_churn_reallocates_nothing():
    """Cache, positions and token buffer are allocated once: their
    storage does not move across admissions and retirements."""
    loop = ServeLoop(MODEL, capacity=3, cache_len=24, prompt_len=8)
    held = [loop.cache["k"], loop.cache["v"], loop.cache["pos"], loop._tok]
    ptrs = [t.data_ptr() for t in held]
    occupancy = set()
    for r in _requests(9, 9):
        loop.submit(**r)
    while loop.pending or loop.active:
        loop.tick()
        occupancy.add(len(loop.slots))
    assert len(occupancy) >= 3
    assert [t.data_ptr() for t in (loop.cache["k"], loop.cache["v"],
                                   loop.cache["pos"], loop._tok)] == ptrs
    assert all(a is b for a, b in zip(held, (loop.cache["k"], loop.cache["v"],
                                             loop.cache["pos"], loop._tok)))
    assert loop.cache["pos"].tolist() == [-1, -1, -1]


def test_reload_copies_weights_in_place():
    prompt = np.arange(6) % CFG.vocab_size
    model = params_from_jax(t_tiny_lm(layers=2), jax.tree.map(np.asarray, PARAMS))
    loop = ServeLoop(model, capacity=2, cache_len=24, prompt_len=8)
    loop.submit(prompt, max_new=4)
    base = loop.run()[-1].tokens
    state = {k: v.clone() for k, v in model.state_dict().items()}
    ptr = model.embed.data_ptr()
    with telemetry() as bus:
        loop.reload({k: v * 2.0 for k, v in state.items()})
        assert torch.equal(model.embed, state["embed"] * 2.0)
        loop.reload(state)
    assert model.embed.data_ptr() == ptr
    assert bus.counters["serve.reloads"] == 2
    loop.submit(prompt, max_new=4)
    assert loop.run()[-1].tokens == base


def test_serve_loop_rejections():
    with pytest.raises(ValueError, match="policy"):
        ServeLoop(MODEL, capacity=2, cache_len=16, prompt_len=8,
                  policy="adaptive")
    with pytest.raises(ValueError, match="prompt_len"):
        ServeLoop(MODEL, capacity=2, cache_len=8, prompt_len=16)
    loop = ServeLoop(MODEL, capacity=2, cache_len=16, prompt_len=8)
    with pytest.raises(ValueError, match="prompt length"):
        loop.submit(np.zeros(9, np.int32))
    with pytest.raises(ValueError, match="max_ticks"):
        loop.submit(np.arange(4), max_ticks=0)


# --------------------------------------------------------------------------
# Entry point, imports
# --------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


@pytest.mark.parametrize("mode", ["batch", "slots"])
def test_cli_runs_on_cpu(mode):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mode", mode, "--requests", "6", "--prompt-len", "8", "--gen", "6"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "tok/s" in out.stdout


def test_cli_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.launch.serve, "
            "repro_torch.models.convert, repro_torch.kernels.build\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
            "assert not any(m.startswith('repro_torch.kernels._build') "
            "for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_port_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(p.relative_to(ROOT)) for p in files}
    for module in ("core/ndmp.py", "core/mixing.py", "overlay/controller.py",
                   "overlay/events.py", "faults/plan.py", "dist/flat.py",
                   "dist/sync.py", "kernels/gather_mix.py", "optim/optimizers.py",
                   "runtime/loop.py", "runtime/masked.py", "launch/steps.py"):
        assert f"src/repro_torch/{module}" in names, module
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, path
