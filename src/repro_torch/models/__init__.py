"""Model initializers (``repro.models``)."""
