"""Run reports and metrics CSVs (reference-format artifacts)."""

from har_tpu_torch.reporting.ascii_table import show
from har_tpu_torch.reporting.report import (
    CSV_HEADER,
    CV_CSV_HEADER,
    ModelResult,
    ReportWriter,
)

__all__ = [
    "show",
    "CSV_HEADER",
    "CV_CSV_HEADER",
    "ModelResult",
    "ReportWriter",
]
