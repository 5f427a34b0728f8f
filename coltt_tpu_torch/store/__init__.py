"""FLAT store (dense modes) and state conversion to and from the JAX package."""
