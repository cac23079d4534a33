"""Atomic, asynchronous training checkpoints (``manager.py``)."""
