"""Architecture configuration — one dataclass covers all 10 assigned
architecture families (dense GQA, MoE, MLA-MoE, SSM, hybrid, enc-dec
audio, early-fusion VLM) plus the reduced smoke variants.

A config is pure data: the model code in :mod:`repro.models.model`
interprets it.  ``src/repro/configs/<id>.py`` files instantiate the
exact assigned specs and cite their sources.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    d_ff_expert: int            # hidden width of each routed expert
    num_shared: int = 0         # always-on shared experts (DeepSeek-V3: 1)
    router_aux_coef: float = 0.001
    moe_every: int = 1          # apply MoE FFN on layers where i % moe_every == offset
    moe_offset: int = 0
    # capacity factor for the static dispatch; num_experts/top_k ⇒ dropless
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention [arXiv:2412.19437]."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD (state-space duality) [arXiv:2405.21060]."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 64             # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: blocks of ``period`` layers; layer
    ``attn_index`` within a block is attention, the rest Mamba."""

    period: int = 8
    attn_index: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 500_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # None = full causal attention
    first_dense_layers: int = 0           # MoE models: leading dense layers
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # encoder-decoder (seamless-m4t): decoder cross-attends into encoder
    # memory. Per the modality carve-out the encoder frontend is a stub:
    # inputs are precomputed frame embeddings of shape (B, enc_len, d_model).
    enc_dec: bool = False
    enc_layers: int = 0
    # DeepSeek-V3 multi-token prediction: extra depth-1 MTP block
    mtp_depth: int = 0
    source: str = ""            # citation for the assigned config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256 (Megatron-style)
        so the vocab dim shards over any reasonable tensor axis; padded
        logit rows are masked to -inf in the model."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def attn_layer_mask(self) -> Tuple[bool, ...]:
        """Which layers are attention (vs Mamba) layers."""
        if self.family == "ssm":
            return tuple(False for _ in range(self.num_layers))
        if self.hybrid is not None:
            p, a = self.hybrid.period, self.hybrid.attn_index
            return tuple((i % p) == a for i in range(self.num_layers))
        return tuple(True for _ in range(self.num_layers))

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """Which layers use the MoE FFN (vs dense MLP / none for SSM)."""
        if self.moe is None:
            return tuple(False for _ in range(self.num_layers))
        m = self.moe
        out = []
        for i in range(self.num_layers):
            if i < self.first_dense_layers:
                out.append(False)
            else:
                out.append((i % m.moe_every) == m.moe_offset)
        return tuple(out)

    # ---- parameter counting (exact, for roofline MODEL_FLOPS) ----------
    def param_count(self, active_only: bool = False) -> int:
        """Exact parameter count; ``active_only`` counts top-k routed
        experts instead of all (MoE activated-params for 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d                     # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                # lm head
        attn_mask = self.attn_layer_mask()
        moe_mask = self.moe_layer_mask()

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * n_q * qk_dim
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                p += n_q * m.v_head_dim * d
                return p
            p = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            return p

        def mlp_params() -> int:
            return 3 * d * self.d_ff                    # SwiGLU

        def moe_params(active: bool) -> int:
            m = self.moe
            e = m.top_k if active else m.num_experts
            p = 3 * d * m.d_ff_expert * (e + m.num_shared)
            p += d * m.num_experts                      # router
            return p

        def ssm_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.nheads(d)
            p = d * (2 * di + 2 * s.d_state + nh)       # in_proj(x,z,B,C,dt)
            p += s.d_conv * (di + 2 * s.d_state)        # conv over x,B,C
            p += nh * 2                                 # A_log, D
            p += di                                     # norm
            p += di * d                                 # out_proj
            return p

        for i in range(self.num_layers):
            total += d  # pre-norm
            if attn_mask[i]:
                total += attn_params() + d              # + post norm
            else:
                total += ssm_params()
                # mamba layers in pure-ssm models have no separate FFN
            if self.family == "ssm":
                continue
            if moe_mask[i]:
                total += moe_params(active_only)
            else:
                total += mlp_params()
        if self.enc_dec:
            # encoder stack (self-attn + MLP) + decoder cross-attention
            enc = self.enc_layers * (attn_params() + mlp_params() + 2 * d)
            cross = self.num_layers * (attn_params() + d)
            total += enc + cross
        if self.mtp_depth:
            total += self.mtp_depth * (attn_params() + moe_params(active_only)
                                       if self.moe else mlp_params())
        return int(total)


# --------------------------------------------------------------------------
# Input shapes (assigned)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=min(cfg.d_model, 256),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64,
        enc_layers=min(cfg.enc_layers, 2),
        first_dense_layers=min(cfg.first_dense_layers, 1),
    )
    if cfg.hybrid is not None:
        # keep the interleave pattern visible in 2 layers: 1 attn + 1 mamba
        changes["hybrid"] = HybridConfig(period=2, attn_index=0)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=min(cfg.moe.d_ff_expert, 256))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, headdim=32, chunk=16)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                   qk_nope_head_dim=32, qk_rope_head_dim=16,
                                   v_head_dim=32)
    return dataclasses.replace(cfg, **changes)
