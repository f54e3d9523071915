"""Neural training of the port."""
