"""Data: the synthetic measures of the paper's experiments
(`repro_torch.data.pointclouds`) and the LM token stream (`TokenPipeline`)."""
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["TokenPipeline"]
