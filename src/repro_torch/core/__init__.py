"""Proxy math, training, scoring and the cascade (``repro.core``), and the
oracles, the LLM judge among them. The same exports as the JAX package's
``repro.core``, with ``LMOracleConfig`` beside ``LMOracle``."""
from repro_torch.core.cascade import (  # noqa: F401
    CascadeResult,
    f1_score,
    naive_cascade,
    probe_cascade,
    run_cascade,
    supg_cascade,
)
from repro_torch.core.encoder import (  # noqa: F401
    decision_scores,
    encoder_apply,
    encoder_init,
    projector_apply,
)
from repro_torch.core.oracle import (LMOracle, LMOracleConfig,  # noqa: F401
                                     SimulatedOracle)
from repro_torch.core.pipeline import QueryStats, ScaleDocPipeline  # noqa: F401
from repro_torch.core.trainer import (  # noqa: F401
    train_proxy,
    train_proxy_multi,
    train_proxy_variant,
    unstack_params,
)
