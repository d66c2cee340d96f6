"""Proxy math, training, scoring and the cascade (``repro.core``)."""
