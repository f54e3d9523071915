"""Data loading and splitting (numpy; copies of har_tpu.data)."""
