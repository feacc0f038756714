"""The training data pipeline: deterministic host-sharded token and
masked-frame streams with double-buffered prefetch (numpy, on the host)."""
