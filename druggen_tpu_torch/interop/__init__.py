"""Checkpoint and parameter interop with the JAX package (numpy only)."""
