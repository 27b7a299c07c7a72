"""Synthetic token batches, the same as the JAX package's for a seed."""
