"""Launchers (``repro.launch``): the LM training CLI (``train``), the
serving CLI (``serve``), meshes (``mesh``), the cell plans (``steps``),
and the dry run (``dryrun``: every cell's plan stepped on meta tensors
under the cost counter, ``hlo_analysis``) with its roofline report
(``roofline``, H100 constants)."""
