"""seamless-m4t-medium — enc-dec multimodal (speech/text) [arXiv:2308.11596].
12L decoder + 12L encoder, d_model=1024, 16 heads (kv=16 = MHA),
d_ff=4096, vocab=256206.

The speech frontend (mel spectrogram + conv feature extractor) is the
stubbed modality frontend per the carve-out: ``input_specs`` supplies
precomputed frame embeddings (B, frames, d_model); the implemented part
is the full transformer encoder + autoregressive text decoder with
cross-attention."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
    enc_dec=True,
    enc_layers=12,
    source="SeamlessM4T [arXiv:2308.11596]",
)
