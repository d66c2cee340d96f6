"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA-style KV: kv=32).
32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]
(a copy of ``repro.configs.codeqwen15_7b``)
"""
from repro_torch.config import BLOCK_ATTN, ModelConfig, register

FULL = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, rope_theta=1000000.0,
    tie_embeddings=False,
    block_pattern=(BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="codeqwen1.5-7b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=256, tie_embeddings=False,
    block_pattern=(BLOCK_ATTN,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
