"""Analysis tools of the port (copies of pic1dp_tpu/analysis modules that need no jax)."""
