"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``'s
``per_layer``, found by name.  Each has ``read(ctx) -> float | None``;
``None`` (nothing to read) leaves the metric out of the result line.
``ctx`` holds the window's spans by layer (host clock), its start ``t0``,
its last finish ``t_end``, the loci it finished, the traced stretch's
reduction (``trace``, or None) and the work counted over that stretch."""
