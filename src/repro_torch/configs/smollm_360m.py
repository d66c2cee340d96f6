"""smollm-360m [dense] — llama-arch small.
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
(a copy of ``repro.configs.smollm_360m``)
"""
from repro_torch.config import BLOCK_ATTN, ModelConfig, register

FULL = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152,
    block_pattern=(BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    block_pattern=(BLOCK_ATTN,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
