"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352
[hf:databricks/dbrx-base]
(a copy of ``repro.configs.dbrx_132b``)
"""
from repro_torch.config import BLOCK_ATTN, ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, rope_theta=500000.0,
    tie_embeddings=False,
    moe=MoEConfig(num_experts=16, top_k=4),
    block_pattern=(BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256, tie_embeddings=False,
    moe=MoEConfig(num_experts=4, top_k=2),
    block_pattern=(BLOCK_ATTN,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
