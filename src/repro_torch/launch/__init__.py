"""Step builders and the serving and training command lines."""
