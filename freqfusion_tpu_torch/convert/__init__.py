"""Weight conversion between the JAX package's params and the port."""
