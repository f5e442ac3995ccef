"""Measurement tools for the card: three probe kernels (``probes.cu``) and
the tools that time them (``roofline``, ``microbench_vpu``,
``microbench_fieldmul``, each run with ``python -m``), and the bound model
(``bound_model``) they check and ``chip_smoke.py`` uses."""
