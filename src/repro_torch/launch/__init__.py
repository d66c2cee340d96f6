"""Launchers (``repro.launch``): the LM training CLI (``train``), the
serving CLI (``serve``), meshes (``mesh``) and the cell plans
(``steps``). The dry-run, HLO-analysis and roofline tools are not
ported yet."""
