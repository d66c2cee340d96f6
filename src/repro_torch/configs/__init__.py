"""Registered architectures (``repro.configs``): importing the package
registers each config module's ``FULL`` and ``SMOKE``. Only llama3-8b
is ported so far."""
from repro_torch.configs import llama3_8b  # noqa: F401
