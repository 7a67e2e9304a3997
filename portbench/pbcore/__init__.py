"""The yardstick of the port's benchmark: traffic, observation, the plain
reference, the counts of work, the device trace and the check. Nothing
here imports ``jax`` or the JAX package; the port (``repro_torch``) is
imported only where a run drives it."""
