"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
(a copy of ``repro.configs.llama3_8b``)
"""
from repro_torch.config import BLOCK_ATTN, ModelConfig, register

FULL = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    tie_embeddings=False,
    block_pattern=(BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="llama3-8b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=224, vocab_size=256, tie_embeddings=False,
    block_pattern=(BLOCK_ATTN,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
