"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json``.  Everything that belongs to one
model configuration, traffic mix, per-layer metric or cell's correctness
limits is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<workload>.json``.

The yardstick lives here and imports nothing of the program: the plain
fp32 reference (``reference.py``), the frozen work counts and peaks
(``arith.py``), the profiler reduction (``trace.py``) and the comparisons
that decide ``correct`` (``checks.py``).  The runners (``runners/``) are
the only modules that call into ``repro_torch``.
"""
