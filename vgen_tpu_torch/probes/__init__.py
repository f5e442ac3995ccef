"""Measurement tools for the card: seven probe kernels (``probes.cu``, their
per-thread bodies in ``probe_lanes.cuh`` and ``geometry_lanes.cuh``), the
tools that time them (``roofline``, ``microbench_vpu``,
``microbench_fieldmul``, ``profile_glv``, ``proto_vtile``,
``microbench_rows``, ``microbench_layout``), kernel A's chain sweep
(``sweep_inv_chain``), kernel F's window sweep and stage split
(``sweep_ladder_window``, ``profile_ladder``), each run with ``python -m``, and the bound model
(``bound_model``) they check and ``chip_smoke.py`` uses."""
