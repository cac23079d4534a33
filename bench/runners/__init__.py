"""Runners: the benchmark's only callers of the program.

Each traffic file names its runner by ``kind``: ``train`` drives
``repro_torch.launch.steps.make_train_step``; ``serve`` drives
``repro_torch.serving.engine.Engine``.  A runner builds the system
under test from a configuration file, makes the inputs from the seed,
warms up, measures the window, and hands the harness its records and
the outputs that ``correct`` is decided on.
"""
