"""The language model of the port: the dense decoder of
``repro/models/model.py`` with its decode cache.

The reference stacks each segment's layers and runs a ``lax.scan`` over
them; here the layers are an ``nn.ModuleList`` walked in Python.  Each
layer mirrors the reference's parameter tree: ``norm1``, ``attn`` (a
``ParameterDict``), ``norm2``, ``mlp`` (a ``ParameterDict``).

API
---
* ``LanguageModel(cfg, generator, dtype)``: weights drawn from
  ``generator`` on its device, with the reference's distributions.
* ``init_cache(model, batch, cache_len, dtype, per_slot_pos)``
* ``prefill(model, cache, tokens, lengths=None)`` → (last-token logits,
  cache primed with the prompt)
* ``decode_step(model, cache, token)`` → (logits, cache advanced)

Training works on a parameter *tree* in the reference's layout instead
of the module (``init_params``'s tree: ``embed``, ``final_norm``, and
per segment ``seg{si}/sub{i}/...`` leaves stacked over the segment's
repeats), so that the tree can be views into one flat row
(:class:`repro_torch.dist.flat.FlatSpec`) and a local step neither
copies a client into a module nor back:

* ``init_params(cfg, generator, dtype)`` → the tree, drawn as the
  module's weights are;
* ``forward(cfg, params, tokens)`` → (logits (B, S, V) f32, aux)
* ``train_loss(cfg, params, batch)`` → the mean next-token
  cross-entropy (``repro/models/model.py:441``).

The cache is ``{"pos", "k", "v"}`` with k and v of shape
(num_layers, B, L, Hkv, hd), allocated once; prefill and decode write it
in place.  ``pos`` is a 0-d tensor for the whole-batch decode loop or a
per-slot (B,) vector for the serving loop, where rows with pos < 0 are
empty slots: zero attention output, position frozen.

Only the dense-attention family is served in this slice; a config with
MLA, MoE, SSM, hybrid or encoder-decoder layers raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from . import attention as attn
from .config import ArchConfig
from .layers import (dense_init, embed_apply, embed_init, mlp_apply, rmsnorm,
                     softmax_xent, unembed_apply)

LayerKind = Tuple[str, Optional[str], bool]   # (mixer, ffn, cross)

_NOT_PORTED = {
    "mla": "MLA decode (ROADMAP.md Queue 1 item 8)",
    "moe": "the MoE FFN (ROADMAP.md Queue 1 item 4)",
    "ssm": "the Mamba2 mixer (ROADMAP.md Queue 1 item 9)",
    "hybrid": "the Mamba2 mixer (ROADMAP.md Queue 1 item 9)",
    "enc_dec": "encoder-decoder cross-attention (ROADMAP.md Queue 1 item 8)",
}


def layer_plan(cfg: ArchConfig) -> List[LayerKind]:
    attn_mask = cfg.attn_layer_mask()
    moe_mask = cfg.moe_layer_mask()
    kinds: List[LayerKind] = []
    for i in range(cfg.num_layers):
        if attn_mask[i]:
            mixer = "mla" if cfg.mla is not None else "attn"
        else:
            mixer = "mamba"
        ffn = None if cfg.family == "ssm" else ("moe" if moe_mask[i] else "dense")
        kinds.append((mixer, ffn, cfg.enc_dec))
    return kinds


def find_segments(kinds: List[LayerKind]) -> List[Tuple[Tuple[LayerKind, ...], int]]:
    """The reference's factoring of the layer plan into (superblock
    pattern, repeats) segments, which fixes how its leaves are stacked."""
    n = len(kinds)
    for p in range(1, min(16, n) + 1):
        if n % p == 0 and n // p > 1 \
                and all(kinds[i] == kinds[i % p] for i in range(n)):
            return [(tuple(kinds[:p]), n // p)]
    segs: List[Tuple[Tuple[LayerKind, ...], int]] = []
    i = 0
    while i < n:
        j = i
        while j < n and kinds[j] == kinds[i]:
            j += 1
        segs.append(((kinds[i],), j - i))
        i = j
    return segs


def check_servable(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer is dense GQA
    attention with a dense MLP."""
    for field, what in _NOT_PORTED.items():
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; this slice serves "
                f"dense-attention models only")


class DecoderLayer(nn.Module):
    """Pre-norm GQA attention + SwiGLU MLP, with residuals."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        dev = gen.device

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        def ones(n):
            return param(torch.ones((n,), dtype=dtype, device=dev))

        self.norm1 = ones(d)
        a = {"wq": dense_init(gen, d, cfg.num_heads * hd, dtype),
             "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
             "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dtype),
             "wo": dense_init(gen, cfg.num_heads * hd, d, dtype)}
        self.attn = nn.ParameterDict({k: param(v) for k, v in a.items()})
        if cfg.qk_norm:
            self.attn["q_norm"] = ones(hd)
            self.attn["k_norm"] = ones(hd)
        self.norm2 = ones(d)
        self.mlp = nn.ParameterDict({
            "w_gate": param(dense_init(gen, d, cfg.d_ff, dtype)),
            "w_up": param(dense_init(gen, d, cfg.d_ff, dtype)),
            "w_down": param(dense_init(gen, cfg.d_ff, d, dtype))})

    def _ffn(self, cfg, x):
        return x + mlp_apply(self.mlp, rmsnorm(self.norm2, x, cfg.rms_eps))

    def prefill(self, cfg: ArchConfig, x: torch.Tensor, kv: dict) -> torch.Tensor:
        h = rmsnorm(self.norm1, x, cfg.rms_eps)
        h, _ = attn.gqa_prefill(self.attn, h, kv, **_attn_kwargs(cfg))
        return self._ffn(cfg, x + h)

    def decode(self, cfg: ArchConfig, x: torch.Tensor, kv: dict,
               pos) -> torch.Tensor:
        h = rmsnorm(self.norm1, x, cfg.rms_eps)
        h, _ = attn.gqa_decode(self.attn, h, kv, pos, **_attn_kwargs(cfg))
        return self._ffn(cfg, x + h)


def _attn_kwargs(cfg: ArchConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                rms_eps=cfg.rms_eps, window=cfg.sliding_window)


class LanguageModel(nn.Module):
    """The dense decoder.  Weights are drawn from ``generator`` and live
    on its device; dense weights are (d_in, d_out), drawn
    U(±1/sqrt(d_in)), embeddings N(0, 0.02²), norms ones, as in the
    reference's ``init_params``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        check_servable(cfg)
        self.cfg = cfg
        dev = generator.device
        self.embed = nn.Parameter(
            embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
            requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
                requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, generator, dtype)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm, unembedding (f32) and the padded-vocab mask."""
        h = rmsnorm(self.final_norm, h, self.cfg.rms_eps)
        table = self.embed if self.cfg.tie_embeddings else self.lm_head
        return _mask_pad(unembed_apply(table, h), self.cfg)


def _mask_pad(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """-1e30 on the padded vocab rows so they never win softmax/argmax."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, torch.full_like(logits, -1e30))


# --------------------------------------------------------------------------
# Decode cache
# --------------------------------------------------------------------------

def init_cache(model: LanguageModel, batch: int, cache_len: int,
               dtype=torch.float32, per_slot_pos: bool = False) -> dict:
    """Allocate the decode cache once.  With ``per_slot_pos`` the cache
    carries a (batch,) int32 position vector set to -1 (every slot
    empty); otherwise a 0-d position at 0.  A sliding window caps each
    layer's cache at ``window`` slots (a ring)."""
    cfg = model.cfg
    length = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    shape = (cfg.num_layers, batch, length, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = model.device
    pos = (torch.full((batch,), -1, dtype=torch.int32, device=dev)
           if per_slot_pos else torch.zeros((), dtype=torch.int32, device=dev))
    return {"pos": pos,
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_rows(cache: dict, start: int, stop: int) -> dict:
    """Views of batch rows [start, stop) of a per-slot cache: writes
    through them land in ``cache``."""
    return {"pos": cache["pos"][start:stop],
            "k": cache["k"][:, start:stop], "v": cache["v"][:, start:stop]}


def _layer_kv(cache: dict, i: int) -> dict:
    return {"k": cache["k"][i], "v": cache["v"][i]}


def prefill(model: LanguageModel, cache: dict, tokens: torch.Tensor,
            lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """One forward pass over tokens (B, P) that primes every layer's
    cache for positions 0..P-1.  Returns (logits (B, V) f32 at each
    row's last prompt token, cache positioned for the first generated
    token).

    ``lengths`` (B,) serves ragged prompts padded to P: row b's prompt
    is tokens[b, :lengths[b]]; the causal mask keeps the padding out of
    real queries, the cache slots past lengths[b] hold inert values
    masked by the per-slot position, and the logits are taken at
    lengths[b] - 1.  Ragged prompts need a per-slot position cache and
    must fit the sliding-window ring."""
    cfg = model.cfg
    B, P = tokens.shape
    per_slot = cache["pos"].dim() == 1
    if lengths is not None:
        if not per_slot:
            raise ValueError("ragged prefill needs a per-slot pos cache "
                             "(init_cache(..., per_slot_pos=True))")
        if cfg.sliding_window and P > cfg.sliding_window:
            raise ValueError("ragged prefill cannot exceed the sliding-window "
                             "ring; trim prompts to the window")
    x = embed_apply(model.embed, tokens)
    for i, layer in enumerate(model.layers):
        x = layer.prefill(cfg, x, _layer_kv(cache, i))
    if lengths is None:
        last = x[:, -1]
        cache["pos"].fill_(P)
    else:
        lengths = torch.as_tensor(lengths, device=x.device)
        last = x[torch.arange(B, device=x.device), lengths.long() - 1]
        cache["pos"].copy_(lengths)
    return model.logits(last), cache


def decode_step(model: LanguageModel, cache: dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token: (B, 1) int.  Returns (logits (B, V) f32,
    cache with this token's K/V written and pos advanced).  Rows with
    pos < 0 are empty slots: their position does not advance and their
    logits are garbage the caller must mask."""
    cfg = model.cfg
    pos = cache["pos"]
    x = embed_apply(model.embed, token)
    for i, layer in enumerate(model.layers):
        x = layer.decode(cfg, x, _layer_kv(cache, i), pos)
    logits = model.logits(x[:, 0])
    if pos.dim() == 0:
        pos.add_(1)
    else:
        pos.add_((pos >= 0).to(pos.dtype))
    return logits, cache


# --------------------------------------------------------------------------
# Training: the parameter tree in the reference's layout
# --------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """A parameter tree in the reference's layout, with the module's
    distributions: dense weights (d_in, d_out) U(±1/sqrt(d_in)),
    embeddings N(0, 0.02²), norms ones.  Each segment's leaves are
    stacked over its repeats.  The tree lives on ``device``, by default
    the generator's; ``device="meta"`` gives its shapes alone."""
    check_servable(cfg)
    dev = generator.device if device is None else torch.device(device)
    d, hd = cfg.d_model, cfg.resolved_head_dim

    def embed():
        w = torch.empty((cfg.padded_vocab, d), dtype=torch.float32, device=dev)
        return (w.normal_(generator=generator) * 0.02).to(dtype)

    def dense(repeats, d_in, d_out):
        s = 1.0 / math.sqrt(d_in)
        w = torch.empty((repeats, d_in, d_out), dtype=torch.float32, device=dev)
        return w.uniform_(-s, s, generator=generator).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    params = {"embed": embed(), "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed()
    for si, (pattern, repeats) in enumerate(find_segments(layer_plan(cfg))):
        seg = {}
        for i in range(len(pattern)):
            attn_p = {"wq": dense(repeats, d, cfg.num_heads * hd),
                      "wk": dense(repeats, d, cfg.num_kv_heads * hd),
                      "wv": dense(repeats, d, cfg.num_kv_heads * hd),
                      "wo": dense(repeats, cfg.num_heads * hd, d)}
            if cfg.qk_norm:
                attn_p["q_norm"] = ones(repeats, hd)
                attn_p["k_norm"] = ones(repeats, hd)
            seg[f"sub{i}"] = {
                "norm1": ones(repeats, d), "attn": attn_p,
                "norm2": ones(repeats, d),
                "mlp": {"w_gate": dense(repeats, d, cfg.d_ff),
                        "w_up": dense(repeats, d, cfg.d_ff),
                        "w_down": dense(repeats, cfg.d_ff, d)}}
        params[f"seg{si}"] = seg
    return params


def _apply_sublayer(p: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Pre-norm GQA attention + SwiGLU MLP with residuals, over the whole
    sequence."""
    h = attn.gqa_apply(p["attn"], rmsnorm(p["norm1"], x, cfg.rms_eps),
                       **_attn_kwargs(cfg))
    x = x + h
    return x + mlp_apply(p["mlp"], rmsnorm(p["norm2"], x, cfg.rms_eps))


def forward(cfg: ArchConfig, params: dict,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V) f32, aux loss 0): embed, every
    layer over the whole causal sequence, final norm, unembedding and
    the padded-vocab mask (``repro/models/model.py:forward``, dense
    family)."""
    check_servable(cfg)
    x = embed_apply(params["embed"], tokens)
    for si, (pattern, repeats) in enumerate(find_segments(layer_plan(cfg))):
        seg = params[f"seg{si}"]
        for r in range(repeats):
            for i in range(len(pattern)):
                sub = seg[f"sub{i}"]
                x = _apply_sublayer(
                    {"norm1": sub["norm1"][r], "norm2": sub["norm2"][r],
                     "attn": {k: v[r] for k, v in sub["attn"].items()},
                     "mlp": {k: v[r] for k, v in sub["mlp"].items()}}, cfg, x)
    h = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = _mask_pad(unembed_apply(table, h), cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def train_loss(cfg: ArchConfig, params: dict, batch: dict) -> torch.Tensor:
    """batch: tokens (B, S), labels (B, S) ints → the mean next-token
    cross-entropy plus the aux loss (``repro/models/model.py:441``; the
    dense family has no MTP head and no aux loss)."""
    logits, aux = forward(cfg, params, batch["tokens"])
    return softmax_xent(logits, batch["labels"]) + aux
