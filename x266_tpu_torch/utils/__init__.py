"""Host-side helpers: rate control (copied from the JAX package) and the
test clips derived from the synthetic ones."""
