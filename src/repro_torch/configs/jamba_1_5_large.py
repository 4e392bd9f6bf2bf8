"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887].  72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576,
vocab=65536, 16 experts top-2 on every other layer.

Block structure: period-8 superblocks with the attention layer at index
0 and Mamba at 1..7 (the paper's 1:7 ratio); MoE FFN on odd layers,
dense on even.  Jamba-1/1.5 ship Mamba-1 mixers; we use the Mamba2 SSD
mixer (our kernelized scan) — recorded in DESIGN.md §deviations.
long_500k decodes natively on the Mamba state; attention layers keep a
sliding-window cache (Jamba's bounded-KV design goal)."""

from ..models.config import ArchConfig, HybridConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    rope_theta=10_000.0,
    hybrid=HybridConfig(period=8, attn_index=0),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, num_shared=0,
                  moe_every=2, moe_offset=1),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=128, chunk=256),
    source="Jamba [arXiv:2403.19887]",
)
