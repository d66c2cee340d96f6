"""Registered architectures (``repro.configs``): importing the package
registers each config module's ``FULL`` and ``SMOKE``. Ported so far:
llama3-8b and smollm-360m (dense) and rwkv6-7b (attention-free)."""
from repro_torch.configs import llama3_8b, rwkv6_7b, smollm_360m  # noqa: F401
