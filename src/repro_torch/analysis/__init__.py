"""Runtime contracts of the port (own copies of the JAX package's)."""
