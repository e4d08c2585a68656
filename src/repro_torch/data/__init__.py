from .pipeline import DataConfig, ZipfLM, byte_corpus, linear_model_batches

__all__ = ["DataConfig", "ZipfLM", "byte_corpus", "linear_model_batches"]
