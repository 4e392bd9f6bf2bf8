"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783].
126L, d_model=16384, 128 heads (GQA kv=8), d_ff=53248, vocab=128256."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="Llama 3 herd [arXiv:2407.21783]",
)
