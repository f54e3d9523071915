"""The WISDM feature pipeline (numpy; copies of har_tpu.features)."""

from har_tpu_torch.features.pipeline import Pipeline, PipelineModel, Estimator, Transformer
from har_tpu_torch.features.string_indexer import StringIndexer, StringIndexerModel
from har_tpu_torch.features.one_hot import OneHotEncoder, OneHotEncoderModel
from har_tpu_torch.features.assembler import VectorAssembler
from har_tpu_torch.features.wisdm_pipeline import build_wisdm_pipeline, FeatureSet, make_feature_set

__all__ = [
    "Pipeline",
    "PipelineModel",
    "Estimator",
    "Transformer",
    "StringIndexer",
    "StringIndexerModel",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "VectorAssembler",
    "build_wisdm_pipeline",
    "FeatureSet",
    "make_feature_set",
]
