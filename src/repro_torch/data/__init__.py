"""Input pipelines (numpy only)."""
