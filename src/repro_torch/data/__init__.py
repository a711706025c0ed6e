"""The port's synthetic data stream (twin of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticStream

__all__ = ["DataConfig", "SyntheticStream"]
