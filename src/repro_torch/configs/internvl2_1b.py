"""internvl2-1b [vlm] — InternViT frontend STUBBED (precomputed patch
embeddings); backbone = InternLM2-like dense LM.
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
[arXiv:2404.16821]
(a copy of ``repro.configs.internvl2_1b``)
"""
from repro_torch.config import BLOCK_ATTN, ModelConfig, register

FULL = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655,
    frontend="vision",
    block_pattern=(BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=160, vocab_size=256,
    frontend="vision",
    block_pattern=(BLOCK_ATTN,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
