"""Weight carriers between the JAX package and the port."""
