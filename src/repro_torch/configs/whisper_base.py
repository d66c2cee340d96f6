"""whisper-base [audio] — enc-dec; conv frontend STUBBED (precomputed frame
embeddings). 6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.
[arXiv:2212.04356]
(a copy of ``repro.configs.whisper_base``)
"""
from repro_torch.config import BLOCK_ATTN, ModelConfig, register

FULL = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, encoder_d_ff=2048,
    d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    frontend="audio", act="gelu",
    block_pattern=(BLOCK_ATTN,),
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="audio",
    num_layers=2, encoder_layers=2, encoder_d_ff=96,
    d_model=48, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=256,
    frontend="audio", act="gelu",
    block_pattern=(BLOCK_ATTN,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
