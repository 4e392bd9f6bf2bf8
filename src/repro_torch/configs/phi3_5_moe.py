"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct].  32L, d_model=4096, 32 heads
(GQA kv=8), expert d_ff=6400, vocab=32064, every layer MoE."""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400, num_shared=0),
    source="Phi-3.5-MoE [hf:microsoft/Phi-3.5-MoE-instruct]",
)
