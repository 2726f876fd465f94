"""Host helpers: parity.py, the oracle gate, and metrics.py, the per-scan
and stream statistics (copies of the JAX package's)."""
