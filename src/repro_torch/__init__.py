"""PyTorch/CUDA port of the MoBA serving and training paths (``repro``
is the JAX reference; this package mirrors it module for module)."""
