"""Deterministic synthetic data pipelines (zipf LM + extreme
classification), numpy only."""
from repro_torch.data.pipeline import (  # noqa: F401
    ExtremeConfig, ExtremeStream, ZipfLM, ZipfLMConfig,
    class_of_features, classification_batch)
