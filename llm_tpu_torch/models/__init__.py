"""Model spec, parameters and the forward pass."""
