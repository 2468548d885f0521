"""The plain reference of the benchmark: what the port's timed path is
judged against.  It imports nothing of the port and nothing of JAX."""
