"""The port's Mamba2 serving path against the JAX reference on the same
numpy inputs and weights (``params_from_jax``): the SSD scan's plain
versions, the mixer's prefill and decode, and the reduced Mamba2-370m
served end to end.

Tolerances: f32 results within 1e-5 of the reference's largest |value|
(the two sides sum in other orders; nothing else differs), model logits
within 1e-4 scaled as in ``test_torch_models.py``, and against the TPU
kernel in interpret mode 2e-4 (f32) and 5e-2 (bf16), as
``tests/test_kernels.py`` holds that kernel to the sequential oracle.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.kernels import ops as jops
from repro.kernels.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduce_for_smoke
from repro_torch.kernels import ssd_scan as scan_mod
from repro_torch.kernels.ref import chunk_len, ssd_chunked_ref, ssd_scan_ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (LanguageModel, decode_step, init_cache,
                                      init_params, prefill, train_loss)
from repro_torch.runtime.serving import ServeLoop

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(a, ref):
    """max |a − ref| over max |ref|."""
    ref = _np(ref)
    return np.abs(_np(a) - ref).max() / np.abs(ref).max()


def _scaled_err(a, ref):
    ref = _np(ref)
    return np.abs(_np(a) - ref).max() / max(1.0, np.abs(ref).max())


def _scan_inputs(seed, B, S, H, P, N, dt_scale=0.2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * dt_scale).astype(np.float32)
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# The SSD scan's plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 96, 3, 16, 32, 64),       # Q halves to 32
    (2, 7, 2, 8, 16, 256),        # Q halves to 7
    (1, 12, 2, 8, 8, 8),          # Q halves to 4
    (1, 256, 4, 64, 128, 64),
])
def test_ssd_chunked_matches_jax(B, S, H, P, N, chunk):
    """y and the final state of the port's plain chunked form (also from a
    given initial state), and of the mixer's ``ssd_chunked`` (through
    ``ssd_scan`` on the CPU), within 1e-5 of max|ref| of
    ``repro.models.ssm.ssd_chunked``; y also against both sequential
    oracles."""
    x, dt, A, Bm, Cm = _scan_inputs(B * S + N, B, S, H, P, N)
    j_in = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, jf = jssm.ssd_chunked(*j_in, chunk=chunk)
    ty, tf = ssd_chunked_ref(*_t(x, dt, A, Bm, Cm), chunk)
    assert ty.dtype == torch.float32 and tf.shape == (B, H, P, N)
    assert _rel(ty, jy) <= TOL and _rel(tf, jf) <= TOL
    my, mf = tssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk)
    assert _rel(my, jy) <= TOL and _rel(mf, jf) <= TOL
    seq = j_ssd_scan_ref(*j_in)
    assert _rel(ty, seq) <= TOL
    assert _rel(ssd_scan_ref(*_t(x, dt, A, Bm, Cm)), seq) <= TOL

    init = np.random.default_rng(S).normal(size=(B, H, P, N)).astype(np.float32)
    jy, jf = jssm.ssd_chunked(*j_in, chunk=chunk, init_state=jnp.asarray(init))
    ty, tf = ssd_chunked_ref(*_t(x, dt, A, Bm, Cm), chunk, torch.from_numpy(init))
    assert _rel(ty, jy) <= TOL and _rel(tf, jf) <= TOL


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 128, 3, 16, 32, 32),
    (2, 96, 2, 32, 16, 32),
    (1, 256, 4, 64, 128, 64),
])
def test_ssd_scan_matches_pallas_interpret(B, S, H, P, N, chunk, dtype):
    """The port's ``ssd_scan`` on the CPU against the TPU kernel run in
    interpret mode, at ``tests/test_kernels.py``'s sweep: 2e-4 (f32) and
    5e-2 (bf16; both sides round y once to bf16), rtol and atol alike."""
    x, dt, A, Bm, Cm = _scan_inputs(S + P, B, S, H, P, N)
    xj, Bj, Cj = (jnp.asarray(a, dtype) for a in (x, Bm, Cm))
    ref = jops.ssd_scan(xj, jnp.asarray(dt), jnp.asarray(A), Bj, Cj,
                        chunk=chunk, interpret=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    xt, Bt, Ct = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in (xj, Bj, Cj))
    y, _ = ssd_scan(xt, *_t(dt, A), Bt, Ct, chunk)
    assert y.dtype == tdt
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == jnp.bfloat16 else \
        dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(y), np.asarray(ref, np.float32), **tol)


def test_ssd_chunk_invariance_and_chunk_len():
    """The chunk is an evaluation order, not a semantic: every chunk gives
    the sequential oracle's y and the same final state within 1e-5 of
    max|ref|; ``chunk_len`` halves as the reference does."""
    assert [chunk_len(S, c) for S, c in
            [(256, 256), (96, 64), (7, 256), (7, 4), (12, 8), (5, 1), (100, 256)]] \
        == [256, 32, 7, 1, 4, 1, 100]
    x, dt, A, Bm, Cm = _scan_inputs(3, 2, 96, 2, 8, 16)
    oracle = ssd_scan_ref(*_t(x, dt, A, Bm, Cm))
    finals = []
    for chunk in (1, 3, 8, 32, 64, 96, 256):
        y, f = ssd_chunked_ref(*_t(x, dt, A, Bm, Cm), chunk)
        assert _rel(y, oracle) <= TOL
        finals.append(f)
    for f in finals[1:]:
        assert _rel(f, finals[0]) <= TOL
    with pytest.raises(ValueError, match="chunk >= 1"):
        chunk_len(8, 0)


def test_ssd_scan_rejects_bad_shapes():
    x, dt, A, Bm, Cm = _t(*_scan_inputs(0, 1, 8, 2, 4, 8))
    with pytest.raises(ValueError, match="x \\(B, S, H, P\\)"):
        ssd_scan(x[0], dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="dt must be"):
        ssd_scan(x, dt[:, :4], A, Bm, Cm)
    with pytest.raises(ValueError, match="Cm must be"):
        ssd_scan(x, dt, A, Bm, Cm[..., :4])
    with pytest.raises(ValueError, match="state_out must be"):
        ssd_scan(x, dt, A, Bm, Cm, state_out=torch.empty((1, 2, 4, 8),
                                                          dtype=torch.float64))
    before = scan_mod.ssd_scan.launches
    ssd_scan(x, dt, A, Bm, Cm)
    assert scan_mod.ssd_scan.launches == before       # the plain path counts none


# --------------------------------------------------------------------------
# The mixer
# --------------------------------------------------------------------------

def _reduced():
    jcfg = j_reduce_for_smoke(REGISTRY["mamba2-370m"])
    tcfg = reduce_for_smoke(T_REGISTRY["mamba2-370m"])
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def reduced_model():
    """The reduced Mamba2-370m (2 layers, d_model 256, 16 heads of 32,
    d_state 32, chunk 16, vocab 512): the reference's parameters with a
    non-zero conv bias and dt bias, and the port's model of them."""
    jcfg, tcfg = _reduced()
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    mamba = params["seg0"]["sub0"]["mamba"]
    for name in ("conv_b", "dt_bias"):
        mamba[name] = jnp.asarray(rng.normal(size=mamba[name].shape) * 0.1,
                                  mamba[name].dtype)
    return jcfg, params, params_from_jax(tcfg, jax.tree.map(np.asarray, params))


def _layer(params, model, i):
    jp = jax.tree.map(lambda a: a[i], params["seg0"]["sub0"]["mamba"])
    return jp, model.layers[i].mamba


@pytest.mark.parametrize("S", [9, 2])
def test_causal_conv_matches_jax(reduced_model, S):
    """S = 2 is shorter than the conv's window of 4."""
    _, params, model = reduced_model
    jp, tp = _layer(params, model, 0)
    xbc = np.random.default_rng(S).normal(
        size=(2, S, tp["conv_w"].shape[1])).astype(np.float32)
    ref = jssm.causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"])
    out = tssm.causal_conv(torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"])
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("S", [40, 2])
def test_mamba_prefill_and_decode_match_jax(reduced_model, S):
    """``mamba_prefill``'s output, state and conv tail (S = 2 is shorter
    than the conv window, so the tail is zero-padded on the left), then
    three ``mamba_decode`` steps, each within 1e-5 of max|ref|."""
    jcfg, params, model = reduced_model
    jp, tp = _layer(params, model, 1)
    s = jcfg.ssm
    rng = np.random.default_rng(S)
    xin = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    jc = jssm.init_ssm_cache(2, jcfg.d_model, s)
    jout, jc = jssm.mamba_prefill(jp, jnp.asarray(xin), jc, s, jcfg.rms_eps)
    cache = tssm.init_ssm_cache(2, jcfg.d_model, s)
    cache["state"].fill_(3.0)                 # fresh-cache semantics: overwritten
    cache["conv"].fill_(3.0)
    state, conv = cache["state"], cache["conv"]
    out, tc = tssm.mamba_prefill(tp, torch.from_numpy(xin), cache, s, jcfg.rms_eps)
    assert tc["state"] is state and tc["conv"] is conv      # written in place
    assert _rel(out, jout) <= TOL
    assert _rel(state, jc["state"]) <= TOL
    assert _rel(conv, jc["conv"]) <= TOL
    for _ in range(3):
        x1 = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jout, jc = jssm.mamba_decode(jp, jnp.asarray(x1), jc, s, jcfg.rms_eps)
        out, _ = tssm.mamba_decode(tp, torch.from_numpy(x1), cache, s, jcfg.rms_eps)
        assert _rel(out, jout) <= TOL
        assert _rel(state, jc["state"]) <= TOL
        assert _rel(conv, jc["conv"]) <= TOL


def test_mamba_init_distributions():
    jcfg, tcfg = _reduced()
    p = tssm.mamba_init(torch.Generator().manual_seed(0), tcfg.d_model, tcfg.ssm)
    j = jssm.mamba_init(jax.random.PRNGKey(0), jcfg.d_model, jcfg.ssm)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in j.items()}
    assert {k: v.dtype for k, v in p.items()} == {
        k: torch.float32 for k in j}
    for name in ("conv_b", "dt_bias", "D", "norm"):
        np.testing.assert_array_equal(_np(p[name]), _np(j[name]))
    # the two libraries' f32 log may differ in the last place
    np.testing.assert_allclose(_np(p["A_log"]), _np(j["A_log"]), rtol=1e-6, atol=0)
    assert p["in_proj"].abs().max() <= 1 / np.sqrt(tcfg.d_model)
    assert abs(p["conv_w"].std().item() - 1 / tcfg.ssm.d_conv) < 0.02


# --------------------------------------------------------------------------
# The model and its entry points
# --------------------------------------------------------------------------

def test_reduced_mamba2_prefill_and_decode_match_jax(reduced_model):
    """Prefill logits and three decode steps of the reduced Mamba2-370m
    within 1e-4 scaled of the reference's, on its weights; the cache
    holds the recurrent state and conv tail of both layers."""
    jcfg, params, model = reduced_model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, params, jmodel.init_cache(jcfg, params, 2, 32),
                            jnp.asarray(toks))
    cache = init_cache(model, 2, 32)
    assert set(cache) == {"pos", "state", "conv"}
    assert cache["state"].shape == (2, 2, 16, 32, 32)
    assert cache["conv"].shape == (2, 2, 3, 512 + 64)
    tl, _ = prefill(model, cache, torch.from_numpy(toks))
    assert _scaled_err(tl, jl) <= 1e-4
    assert _rel(cache["state"], jc["seg0"]["sub0"]["ssm"]["state"]) <= 1e-4
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jcfg, params, jc, jnp.asarray(nxt))
        tl, _ = decode_step(model, cache, torch.from_numpy(nxt))
        assert _scaled_err(tl, jl) <= 1e-4
    assert int(cache["pos"]) == int(jc["pos"]) == 27


def test_ssm_prefill_equals_stepped_decode(reduced_model):
    """One prefill pass ≡ the prompt fed one token at a time through
    ``decode_step``: logits within 2e-4 scaled, states within 1e-4."""
    _, _, model = reduced_model
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (2, 20)))
    c1 = init_cache(model, 2, 24)
    for t in range(20):
        l1, _ = decode_step(model, c1, toks[:, t:t + 1])
    c2 = init_cache(model, 2, 24)
    l2, _ = prefill(model, c2, toks)
    assert _scaled_err(l2, l1) <= 2e-4
    assert _rel(c2["state"], c1["state"]) <= 1e-4
    assert torch.allclose(c2["conv"], c1["conv"], rtol=0, atol=1e-6)
    assert torch.equal(c1["pos"], c2["pos"])


def test_ssm_rejections(reduced_model):
    """Ragged prefill, the slot loop and training raise for an SSM stack,
    as the reference does (training: not ported yet); the hybrid stack
    raises naming the MoE item."""
    _, _, model = reduced_model
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="per-slot pos"):
        prefill(model, init_cache(model, 2, 8), toks, lengths=torch.tensor([2, 4]))
    with pytest.raises(ValueError, match="SSM/hybrid"):
        prefill(model, init_cache(model, 2, 8, per_slot_pos=True), toks,
                lengths=torch.tensor([2, 4]))
    with pytest.raises(ValueError, match="SSM"):
        ServeLoop(model, capacity=2, cache_len=16, prompt_len=8)
    cfg = model.cfg
    with pytest.raises(NotImplementedError, match="item 13"):
        init_params(cfg, torch.Generator())
    with pytest.raises(NotImplementedError, match="item 13"):
        train_loss(cfg, {}, {"tokens": toks, "labels": toks})
    with pytest.raises(NotImplementedError, match="item 4"):
        LanguageModel(reduce_for_smoke(T_REGISTRY["jamba-1.5-large-398b"]),
                      torch.Generator())


def test_full_size_parameter_count():
    """Mamba2-370m at full width: one layer built on the CPU, and 48 of
    them with the tied 50,432-row embedding come to the reference
    config's parameter count (which leaves out the vocab padding, the conv
    and dt biases and the final norm) and to about 1.48 GB in f32."""
    cfg = T_REGISTRY["mamba2-370m"]
    one = LanguageModel(dataclasses.replace(cfg, num_layers=1),
                        torch.Generator().manual_seed(0))
    layer = sum(p.numel() for p in one.layers[0].parameters())
    n = cfg.padded_vocab * cfg.d_model + cfg.d_model + cfg.num_layers * layer
    di, nh = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.nheads(cfg.d_model)
    extra = ((cfg.padded_vocab - cfg.vocab_size) * cfg.d_model + cfg.d_model
             + cfg.num_layers * (di + 2 * cfg.ssm.d_state + nh))
    assert n == cfg.param_count() + extra
    assert abs(4 * n / 1e9 - 1.48) < 0.01


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_cli_serves_mamba2_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "mamba2-370m", "--prompt-len", "20", "--gen", "5"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "mamba2-370m-smoke" in out.stdout and "tok/s" in out.stdout
