"""qwen3-4b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family].
36L, d_model=2560, 32 heads (GQA kv=8, head_dim=128), d_ff=9728,
vocab=151936."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="Qwen3 [hf:Qwen/Qwen3-8B]",
)
