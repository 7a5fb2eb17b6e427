"""The port's own copies of the JAX package's ``types/`` names that it
needs (``constants``)."""
