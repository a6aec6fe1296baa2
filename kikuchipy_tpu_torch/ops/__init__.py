"""Pattern kernels and the fused indexing kernel."""
