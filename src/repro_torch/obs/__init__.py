"""Observability helpers in the JAX package's metrics schema."""
