"""Attention math: routing, MoBA, dense/SWA, and the backend registry."""
