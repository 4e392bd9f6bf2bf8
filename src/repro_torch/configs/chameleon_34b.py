"""chameleon-34b — early-fusion VLM [arXiv:2405.09818].
48L, d_model=8192, 64 heads (GQA kv=8), d_ff=22016, vocab=65536.

Early fusion means image content enters as discrete VQ tokens inside the
same 65536-entry vocabulary — the backbone is an ordinary decoder-only
transformer (with qk-norm, which Chameleon introduced for training
stability).  The VQ-GAN image tokenizer is the stubbed modality
frontend per the carve-out: ``input_specs`` supplies token ids that are
an interleaved text/image stream."""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,            # Chameleon's qk-norm stability fix
    rope_theta=10_000.0,
    source="Chameleon early-fusion [arXiv:2405.09818]",
)
