"""Optimizer: AdamW with a cosine schedule on the param dict."""
