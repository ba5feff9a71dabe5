"""Fault injection (``inject``); the checkpoint lineage and elastic
rescaling of the JAX package's ``resilience`` come later."""
