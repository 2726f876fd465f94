"""Host runtime: native.py, the g++-built PCD / LZF reader and batch stager
(a copy of the JAX package's runtime)."""
