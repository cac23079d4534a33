"""PyTorch/CUDA port of the MoBA serving path (``repro`` is the JAX
reference; this package mirrors it module for module)."""
