"""Device ops: packed weights, layers, and the two kernels' wrappers."""
