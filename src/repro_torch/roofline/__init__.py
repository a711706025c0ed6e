from .analysis import Roofline, collective_bytes, model_flops, roofline

__all__ = ["Roofline", "collective_bytes", "model_flops", "roofline"]
