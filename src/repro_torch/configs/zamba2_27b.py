"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared-weight attention blocks.
54L d_model=2560 32H (GQA kv=32) d_ff=10240 ssm_state=64 vocab=32000
[arXiv:2411.15242]
(a copy of ``repro.configs.zamba2_27b``)

Pattern: every 6th layer applies the single shared attention+MLP block
(Zamba2's shared transformer block; per-application LoRA omitted, as in
the JAX package).
"""
from repro_torch.config import (BLOCK_MAMBA2, BLOCK_SHARED_ATTN, ModelConfig,
                                SSMConfig, register)

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(state_dim=64, conv_width=4, head_dim=64, expand=2),
    block_pattern=(BLOCK_MAMBA2,) * 5 + (BLOCK_SHARED_ATTN,),
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke", family="hybrid",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    ssm=SSMConfig(state_dim=16, conv_width=4, head_dim=16, expand=2,
                  chunk=8),
    block_pattern=(BLOCK_MAMBA2,) * 5 + (BLOCK_SHARED_ATTN,),
    dtype="float32", remat="none",
)

register(FULL, SMOKE)
