"""deepseek-v3-671b — MoE with MLA + MTP [arXiv:2412.19437].
61L, d_model=7168, 128 heads (MLA latent attention), expert d_ff=2048,
vocab=129280, 1 shared + 256 routed experts top-8, first 3 layers dense
(dense d_ff=18432 per the tech report), multi-token-prediction depth 1.

MLA dims per the report: q_lora 1536, kv_lora 512, 128/64 nope/rope head
dims, v_head 128.  The sigmoid+bias-balanced router is simplified to
softmax top-k + aux loss (DESIGN.md §deviations)."""

from ..models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: latent cache is shared; heads decompress
    d_ff=18432,              # dense d_ff for the first_dense_layers
    vocab_size=129280,
    rope_theta=10_000.0,
    first_dense_layers=3,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
    source="DeepSeek-V3 [arXiv:2412.19437]",
)
