"""mamba2-370m — attention-free SSM, SSD (state-space duality)
[arXiv:2405.21060].  48L, d_model=1024, ssm_state=128, vocab=50280.
d_inner = 2·d_model = 2048, headdim 64 → 32 SSD heads.  long_500k is
native: O(1) recurrent decode state."""

from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=32,            # SSD heads (d_inner / headdim)
    num_kv_heads=32,
    d_ff=0,                  # attention-free, no separate FFN
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, headdim=64, chunk=256),
    source="SSD / Mamba2 [arXiv:2405.21060]",
)
