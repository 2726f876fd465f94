"""Pipeline stages on tensors; the kernel wrappers live in rank.py (K5),
place.py (K6), stencil_kernels.py (K7) and gather.py (K11)."""
