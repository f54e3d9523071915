"""The WISDM feature pipeline (numpy; copies of har_tpu.features)."""
