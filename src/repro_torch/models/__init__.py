"""Model primitives and the decoder-only LM."""
