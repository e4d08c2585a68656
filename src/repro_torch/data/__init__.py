from .pipeline import DataConfig, ZipfLM

__all__ = ["DataConfig", "ZipfLM"]
