"""Host-side helpers: rate control and structured metrics (copied from
the JAX package) and the test clips derived from the synthetic ones."""
