"""Host-side parallelism of the port."""
