"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.
32L d_model=4096 d_ff=14336 vocab=65536 head_dim=64
[arXiv:2404.05892]
(a copy of ``repro.configs.rwkv6_7b``)
"""
from repro_torch.config import BLOCK_RWKV6, ModelConfig, RWKVConfig, register

FULL = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64),
    block_pattern=(BLOCK_RWKV6,),
)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=224, vocab_size=256,
    rwkv=RWKVConfig(head_dim=16),
    block_pattern=(BLOCK_RWKV6,), dtype="float32", remat="none",
)

register(FULL, SMOKE)
