"""The plain reference the benchmark holds the port to: the maze raster,
the casters and the filter tick in numpy and plain torch.  It imports
nothing of the port and nothing of JAX."""
