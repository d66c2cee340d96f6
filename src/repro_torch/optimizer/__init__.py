"""The proxy optimizer (``repro.optimizer``)."""
