"""Host helpers: parity.py, the oracle gate (a copy of the JAX package's)."""
