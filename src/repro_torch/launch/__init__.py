"""Launchers (``repro.launch``): the LM training CLI. The mesh, the
step plans and the dry-run and roofline tools wait for the launch and
mesh slice."""
