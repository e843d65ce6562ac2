from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "make_pipeline"]
