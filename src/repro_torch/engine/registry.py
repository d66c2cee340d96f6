"""Cascade-strategy registry (a copy of ``repro.engine.registry``).

The seed exposed its cascade variants as ad-hoc free functions with
slightly different signatures (``run_cascade`` threads an rng; the §6.5
baselines don't). The registry normalizes them behind one callable
shape so the engine — and anything else — selects a strategy by name:

    strategy = get_strategy("scaledoc")
    result = strategy(scores, oracle, cfg, ground_truth=truth, rng=rng)

Third parties register their own with the decorator:

    @register_strategy("my-cascade")
    def my_cascade(scores, oracle, cfg, ground_truth=None, rng=None): ...
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core import cascade as cascade_mod
from repro_torch.core.cascade import CascadeResult

# strategy(scores, oracle, cfg, ground_truth=None, rng=None) -> CascadeResult
Strategy = Callable[..., CascadeResult]
# calibrator(scores, oracle, cfg, rng=None) -> ThresholdSpec — the
# calibration half of a *threshold* strategy. Strategies with a
# calibrator get lazy execution inside the engine: thresholds computed
# once over the full collection, the ambiguous band resolved per pending
# set. Strategies without one (probe, ad-hoc registrations) run whole.
Calibrator = Callable[..., cascade_mod.ThresholdSpec]

_STRATEGIES: Dict[str, Strategy] = {}
_CALIBRATORS: Dict[str, Calibrator] = {}


def register_strategy(name: str) -> Callable[[Strategy], Strategy]:
    def deco(fn: Strategy) -> Strategy:
        if name in _STRATEGIES:
            raise ValueError(f"cascade strategy {name!r} already registered")
        _STRATEGIES[name] = fn
        return fn
    return deco


def register_calibrator(name: str) -> Callable[[Calibrator], Calibrator]:
    def deco(fn: Calibrator) -> Calibrator:
        if name in _CALIBRATORS:
            raise ValueError(f"calibrator {name!r} already registered")
        _CALIBRATORS[name] = fn
        return fn
    return deco


def get_strategy(name: str) -> Strategy:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise KeyError(f"unknown cascade strategy {name!r}; "
                       f"available: {sorted(_STRATEGIES)}") from None


def get_calibrator(name: str) -> Optional[Calibrator]:
    """The threshold calibrator for ``name``, or None when the strategy
    only exists whole (the engine then evaluates it full-collection)."""
    return _CALIBRATORS.get(name)


def available_strategies() -> list:
    return sorted(_STRATEGIES)


@register_strategy("scaledoc")
def _scaledoc(scores, oracle, cfg, ground_truth=None, rng=None):
    return cascade_mod.run_cascade(scores, oracle, cfg,
                                   ground_truth=ground_truth, rng=rng)


@register_strategy("naive")
def _naive(scores, oracle, cfg, ground_truth=None, rng=None):
    return cascade_mod.naive_cascade(scores, oracle, cfg,
                                     ground_truth=ground_truth)


@register_strategy("probe")
def _probe(scores, oracle, cfg, ground_truth=None, rng=None):
    return cascade_mod.probe_cascade(scores, oracle, cfg,
                                     ground_truth=ground_truth)


@register_strategy("supg")
def _supg(scores, oracle, cfg, ground_truth=None, rng=None):
    return cascade_mod.supg_cascade(scores, oracle, cfg,
                                    ground_truth=ground_truth)


@register_calibrator("scaledoc")
def _scaledoc_calibrator(scores, oracle, cfg, rng=None):
    return cascade_mod.calibrate_thresholds(scores, oracle, cfg, rng)


@register_calibrator("naive")
def _naive_calibrator(scores, oracle, cfg, rng=None):
    # naive calibration is seeded by cfg.seed alone (matches the whole-
    # strategy behaviour); the leaf rng is accepted and ignored
    return cascade_mod.naive_thresholds(scores, oracle, cfg)


@register_calibrator("supg")
def _supg_calibrator(scores, oracle, cfg, rng=None):
    return cascade_mod.supg_thresholds(scores, oracle, cfg)
