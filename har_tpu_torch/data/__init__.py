"""Data loading and splitting (numpy; copies of har_tpu.data), and the
host→device prefetch of the streamed trainer."""

from har_tpu_torch.data.schema import ColumnType, Schema, infer_schema
from har_tpu_torch.data.table import Table
from har_tpu_torch.data.csv_loader import read_csv
from har_tpu_torch.data.split import random_split
from har_tpu_torch.data.spark_split import mllib_vocab, spark_split_indices
from har_tpu_torch.data.wisdm import load_wisdm, WISDM_NUMERIC_COLUMNS, WISDM_CATEGORICAL_COLUMNS
from har_tpu_torch.data.synthetic import synthetic_wisdm
from har_tpu_torch.data.raw_loader import RawStream, load_raw_stream, stream_windows
from har_tpu_torch.data.prefetch import prefetch_to_device

__all__ = [
    "RawStream",
    "prefetch_to_device",
    "load_raw_stream",
    "stream_windows",
    "ColumnType",
    "Schema",
    "infer_schema",
    "Table",
    "read_csv",
    "random_split",
    "spark_split_indices",
    "mllib_vocab",
    "load_wisdm",
    "synthetic_wisdm",
    "WISDM_NUMERIC_COLUMNS",
    "WISDM_CATEGORICAL_COLUMNS",
]
