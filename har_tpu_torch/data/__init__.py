"""Data loading and splitting (numpy; copies of har_tpu.data), and the
host→device prefetch of the streamed trainer."""

from har_tpu_torch.data.prefetch import prefetch_to_device

__all__ = ["prefetch_to_device"]
