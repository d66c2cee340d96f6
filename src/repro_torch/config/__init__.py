"""The port's configuration (``repro.config``): the dataclasses of
``config.base`` and the architecture registry of ``config.registry``,
re-exported."""
from repro_torch.config.base import (  # noqa: F401
    BLOCK_ATTN,
    BLOCK_LOCAL_ATTN,
    BLOCK_MAMBA2,
    BLOCK_RWKV6,
    BLOCK_SHARED_ATTN,
    CONTRASTIVE_IMPLS,
    CascadeConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    ProxyConfig,
    RWKVConfig,
    SSMConfig,
    replace,
)
from repro_torch.config.registry import (  # noqa: F401
    get_arch,
    get_smoke_arch,
    list_archs,
    register,
)
