"""Multi-wedge paths: azimuth_parallel.make_azimuth_pipeline runs one scan
cut into azimuth wedges (the JAX package's SP path), the wedges on one card."""
