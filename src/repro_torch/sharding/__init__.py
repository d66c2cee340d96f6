"""The logical-axis sharding rules (``repro.sharding``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    FSDP_RULES,
    FallbackEvent,
    NamedSharding,
    P,
    RuleSet,
    is_axes,
    map_axes,
    place,
    placements,
    tree_shardings,
)
