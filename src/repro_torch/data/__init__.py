from .pipeline import PrefetchPipeline, SyntheticLM

__all__ = ["PrefetchPipeline", "SyntheticLM"]
