"""Step builders and the serving command line."""
