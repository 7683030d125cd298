"""Plain PyTorch/NumPy references: the models, the phantoms and the
operation counts the benchmark holds the port to.  Nothing here imports
the port or JAX."""
