"""Multi-device layers of the port (only single-device attention so far)."""
