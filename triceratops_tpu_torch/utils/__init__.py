"""Instrumentation helpers (counterpart of the JAX package's ``utils``)."""
