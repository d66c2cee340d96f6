"""The port's configuration (``repro.config``): the dataclasses of
``config.base`` and the architecture registry of ``config.registry``,
re-exported."""
from repro_torch.config.base import (  # noqa: F401
    ALL_SHAPES,
    BLOCK_ATTN,
    BLOCK_LOCAL_ATTN,
    BLOCK_MAMBA2,
    BLOCK_RWKV6,
    BLOCK_SHARED_ATTN,
    CONTRASTIVE_IMPLS,
    CascadeConfig,
    DECODE_32K,
    InputShape,
    LONG_500K,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    PREFILL_32K,
    ProxyConfig,
    RWKVConfig,
    SHAPES_BY_NAME,
    SSMConfig,
    TRAIN_4K,
    TrainConfig,
    replace,
)
from repro_torch.config.registry import (  # noqa: F401
    get_arch,
    get_smoke_arch,
    list_archs,
    register,
)
