"""Host-side helpers (copied from the JAX package's ``utils``)."""
