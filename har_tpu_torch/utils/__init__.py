"""Step timing."""

from har_tpu_torch.utils.profiling import StepTimer, trace, write_timing_csv

__all__ = ["StepTimer", "trace", "write_timing_csv"]
