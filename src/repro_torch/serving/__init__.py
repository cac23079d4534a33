"""Paged-KV continuous-batching serving: pools, scheduler, engine."""
