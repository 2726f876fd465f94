"""Multi-scan and multi-wedge paths: data_parallel.make_sharded_pipeline
splits a batch of scans over a list of devices; azimuth_parallel.
make_azimuth_pipeline runs one scan cut into azimuth wedges (the JAX
package's SP path), the wedges on one card or over the ranks of a
torch.distributed process group."""
