"""Deterministic synthetic data pipeline."""
from .pipeline import DataConfig, DataIterator, make_batch

__all__ = ["DataConfig", "DataIterator", "make_batch"]
