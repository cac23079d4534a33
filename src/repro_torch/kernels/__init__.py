"""Hand-written Hopper kernels of the port, one per TPU kernel of
``repro.kernels`` (see PERF.md for which are ported)."""
