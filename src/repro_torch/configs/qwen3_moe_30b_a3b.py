"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, fine-grained d_ff=768.
48L d_model=2048 32H (GQA kv=4) vocab=151936
[hf:Qwen/Qwen3-30B-A3B]
(a copy of ``repro.configs.qwen3_moe_30b_a3b``)
"""
from repro_torch.config import BLOCK_ATTN, ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, rope_theta=1000000.0,
    head_dim=128, tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=8),
    block_pattern=(BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=32, vocab_size=256, head_dim=16, tie_embeddings=False,
    moe=MoEConfig(num_experts=8, top_k=2),
    block_pattern=(BLOCK_ATTN,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
