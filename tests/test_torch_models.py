"""The port's layers, attention and model against the JAX reference on
the same numpy inputs and weights (``params_from_jax``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import REGISTRY
from repro.configs import reduce_for_smoke as j_reduce_for_smoke
from repro.launch.train import tiny_lm
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduce_for_smoke, tiny_lm as t_tiny_lm
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import (LanguageModel, decode_step, init_cache,
                                      prefill)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Keep each xdist worker's intra-op pool small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _pdict(jtree):
    return nn.ParameterDict({k: nn.Parameter(_t(v), requires_grad=False)
                             for k, v in jtree.items()})


def _close(a, b, tol=TOL):
    assert np.abs(_np(a) - _np(b)).max() <= tol


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    _close(tlayers.matmul(_t(x), _t(w)), jlayers.matmul(jnp.asarray(x), jnp.asarray(w)))
    _close(tlayers.rmsnorm(_t(g), _t(x), 1e-5),
           jlayers.rmsnorm(jnp.asarray(g), jnp.asarray(x), 1e-5))
    xr = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(5), np.arange(3, 8)]).astype(np.int32)
    _close(tlayers.apply_rope(_t(xr), torch.from_numpy(pos), 5e5),
           jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 5e5))
    p = jlayers.mlp_init(jax.random.PRNGKey(1), 64, 96)
    _close(tlayers.mlp_apply(_pdict(p), _t(x)), jlayers.mlp_apply(p, jnp.asarray(x)))
    table = rng.standard_normal((50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5))
    _close(tlayers.embed_apply(_t(table), torch.from_numpy(toks)),
           jlayers.embed_apply(jnp.asarray(table), jnp.asarray(toks)))
    logits = tlayers.unembed_apply(_t(table), _t(x))
    assert logits.dtype == torch.float32
    _close(logits, jlayers.unembed_apply(jnp.asarray(table), jnp.asarray(x)))


def test_init_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 256, 512)
    assert w.shape == (256, 512) and w.abs().max() <= 1 / 16
    e = tlayers.embed_init(gen, 1024, 256)
    assert abs(e.std().item() - 0.02) < 1e-3


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

KW = dict(num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=1e4)


def _gqa(rng, B=2, L=8, qk_norm=False):
    p = jattn.gqa_init(jax.random.PRNGKey(0), 32, 4, 2, 8, qk_norm=qk_norm)
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    k0 = rng.standard_normal((B, L, 2, 8)).astype(np.float32)
    v0 = rng.standard_normal((B, L, 2, 8)).astype(np.float32)
    return p, x, k0, v0


@pytest.mark.parametrize("pos,window", [
    (5, None), ([3, 6], None), ([2, -1], None), (11, 8), ([9, 4], 8)])
def test_gqa_decode_matches_jax(pos, window):
    rng = np.random.default_rng(1)
    p, x, k0, v0 = _gqa(rng, qk_norm=True)
    jout, jc = jattn.gqa_decode(p, jnp.asarray(x), {"k": jnp.asarray(k0),
                                                    "v": jnp.asarray(v0)},
                                jnp.asarray(pos), window=window, **KW)
    cache = {"k": _t(k0), "v": _t(v0)}
    tpos = torch.tensor(pos, dtype=torch.int32)
    out, tc = tattn.gqa_decode(_pdict(p), _t(x), cache, tpos, window=window, **KW)
    assert tc is cache                      # written in place
    _close(out, jout)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    if np.ndim(pos) == 1 and -1 in pos:
        assert torch.all(out[pos.index(-1)] == 0)


def test_gqa_decode_overflow_raises():
    rng = np.random.default_rng(3)
    p, x, k0, v0 = _gqa(rng)
    pd = _pdict(p)

    def run(pos, **kw):
        return tattn.gqa_decode(pd, _t(x), {"k": _t(k0), "v": _t(v0)}, pos,
                                **KW, **kw)
    with pytest.raises(ValueError, match="overflows"):
        run(8)
    with pytest.raises(ValueError, match="overflows"):
        run(torch.tensor([3, 8]))
    out, _ = run(8, window=8)                   # the ring does not raise
    assert out.shape == (2, 1, 32)
    with pytest.raises(ValueError, match="per-slot vector"):
        run(torch.tensor([1, 2, 3]))


@pytest.mark.parametrize("P,L,window", [(6, 8, None), (8, 8, None),
                                        (8, 4, 4), (12, 12, 5)])
def test_gqa_prefill_matches_jax(P, L, window):
    rng = np.random.default_rng(P + L)
    p = jattn.gqa_init(jax.random.PRNGKey(2), 32, 4, 2, 8)
    x = rng.standard_normal((2, P, 32)).astype(np.float32)
    zeros = np.zeros((2, L, 2, 8), np.float32)
    jout, jc = jattn.gqa_prefill(p, jnp.asarray(x), {"k": jnp.asarray(zeros),
                                                     "v": jnp.asarray(zeros)},
                                 window=window, **KW)
    cache = {"k": _t(zeros), "v": _t(zeros)}
    out, _ = tattn.gqa_prefill(_pdict(p), _t(x), cache, window=window, **KW)
    _close(out, jout)
    _close(cache["k"], jc["k"])
    _close(cache["v"], jc["v"])


def test_blockwise_attention_chunked_matches_jax():
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 16, 4, 8)).astype(np.float32),
               rng.standard_normal((1, 16, 2, 8)).astype(np.float32),
               rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
    for window in (None, 3):
        ref = jattn._blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                         window=window, chunk=4)
        out = tattn.blockwise_attention(_t(q), _t(k), _t(v), window=window,
                                        chunk=4)
        _close(out, ref)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------

def _jax_model(jcfg, tcfg):
    """The reference's parameters for ``jcfg`` and the port's model of the
    same weights under its own copy of the config, ``tcfg``."""
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return params, params_from_jax(tcfg, jax.tree.map(np.asarray, params))


def _scaled_err(a, ref):
    ref = _np(ref)
    return np.abs(_np(a) - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("window", [None, 4])
def test_prefill_and_decode_logits_match_jax(window):
    cfg = dataclasses.replace(tiny_lm(layers=2), sliding_window=window)
    params, model = _jax_model(cfg, dataclasses.replace(
        t_tiny_lm(layers=2), sliding_window=window))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jc = jmodel.prefill(cfg, params, jmodel.init_cache(cfg, params, 2, 24),
                            jnp.asarray(toks))
    cache = init_cache(model, 2, 24)
    tl, _ = prefill(model, cache, torch.from_numpy(toks))
    assert _scaled_err(tl, jl) <= 1e-4
    assert int(cache["pos"]) == 8
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(cfg, params, jc, jnp.asarray(nxt))
        tl, _ = decode_step(model, cache, torch.from_numpy(nxt))
        assert _scaled_err(tl, jl) <= 1e-4
    assert int(cache["pos"]) == int(jc["pos"]) == 11


def test_ragged_prefill_and_vector_decode_match_jax():
    cfg = tiny_lm(layers=2)
    params, model = _jax_model(cfg, t_tiny_lm(layers=2))
    rng = np.random.default_rng(6)
    lens = np.asarray([3, 8, 5], np.int32)
    toks = np.zeros((3, 8), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab_size, n)
    jc = jmodel.init_cache(cfg, params, 3, 16, per_slot_pos=True)
    jl, jc = jmodel.prefill(cfg, params, jc, jnp.asarray(toks),
                            lengths=jnp.asarray(lens))
    cache = init_cache(model, 3, 16, per_slot_pos=True)
    tl, _ = prefill(model, cache, torch.from_numpy(toks),
                    lengths=torch.from_numpy(lens))
    assert _scaled_err(tl, jl) <= 1e-4
    assert cache["pos"].tolist() == lens.tolist()
    # empty the middle slot: its position must stay frozen
    jc["pos"] = jc["pos"].at[1].set(-1)
    cache["pos"][1] = -1
    nxt = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jc = jmodel.decode_step(cfg, params, jc, jnp.asarray(nxt))
    tl, _ = decode_step(model, cache, torch.from_numpy(nxt))
    assert _scaled_err(tl[[0, 2]], jl[np.asarray([0, 2])]) <= 1e-4
    assert cache["pos"].tolist() == [4, -1, 6] == np.asarray(jc["pos"]).tolist()


def test_prefill_rejections():
    cfg = t_tiny_lm(layers=2)
    model = LanguageModel(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="per-slot pos"):
        prefill(model, init_cache(model, 2, 16), toks,
                lengths=torch.tensor([2, 4]))
    with pytest.raises(ValueError, match="overflows"):
        prefill(model, init_cache(model, 1, 4),
                torch.zeros((1, 8), dtype=torch.int32))


def test_prefill_equals_stepped_decode():
    cfg = t_tiny_lm(layers=2)
    model = LanguageModel(cfg, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(
        np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8)))
    c1 = init_cache(model, 2, 24)
    for t in range(8):
        l1, _ = decode_step(model, c1, toks[:, t:t + 1])
    c2 = init_cache(model, 2, 24)
    l2, _ = prefill(model, c2, toks)
    assert _scaled_err(l1, l2) <= 2e-4
    assert torch.equal(c1["pos"], c2["pos"])


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_unported_families_raise(name):
    cfg = reduce_for_smoke(T_REGISTRY[name])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LanguageModel(cfg, torch.Generator())


def test_qk_norm_model_matches_jax():
    """qwen3 family (qk-norm), reduced: converted weights, same logits."""
    cfg = dataclasses.replace(j_reduce_for_smoke(REGISTRY["qwen3-4b"]),
                              vocab_size=300)
    params, model = _jax_model(cfg, dataclasses.replace(
        reduce_for_smoke(T_REGISTRY["qwen3-4b"]), vocab_size=300))
    toks = np.random.default_rng(8).integers(0, 300, (1, 6)).astype(np.int32)
    jl, _ = jmodel.prefill(cfg, params, jmodel.init_cache(cfg, params, 1, 8),
                           jnp.asarray(toks))
    tl, _ = prefill(model, init_cache(model, 1, 8), torch.from_numpy(toks))
    assert _scaled_err(tl, jl) <= 1e-4
    assert tl[:, 300:].max().item() == np.float32(-1e30)     # padded vocab masked


def test_config_copies_match_reference():
    assert sorted(T_REGISTRY) == sorted(REGISTRY)
    for name, cfg in REGISTRY.items():
        assert dataclasses.asdict(T_REGISTRY[name]) == dataclasses.asdict(cfg)
        assert (dataclasses.asdict(reduce_for_smoke(T_REGISTRY[name]))
                == dataclasses.asdict(j_reduce_for_smoke(cfg)))
        assert T_REGISTRY[name].padded_vocab == cfg.padded_vocab
        assert (T_REGISTRY[name].param_count()
                == cfg.param_count())
    assert dataclasses.asdict(t_tiny_lm()) == dataclasses.asdict(tiny_lm())
