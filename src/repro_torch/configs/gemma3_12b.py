"""gemma3-12b [dense] — 5:1 local:global attention, 256k vocab.
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 window=1024
[hf:google/gemma-3-1b-pt]
(a copy of ``repro.configs.gemma3_12b``)
"""
from repro_torch.config import (BLOCK_ATTN, BLOCK_LOCAL_ATTN, ModelConfig,
                                register)

FULL = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262144, rope_theta=1000000.0,
    sliding_window=1024,
    block_pattern=(BLOCK_LOCAL_ATTN,) * 5 + (BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke", family="dense",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=512, sliding_window=16,
    block_pattern=(BLOCK_LOCAL_ATTN,) * 5 + (BLOCK_ATTN,),
    dtype="float32", remat="none",
)

register(FULL, SMOKE)
