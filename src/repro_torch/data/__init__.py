from repro_torch.data.pipeline import DataConfig, SyntheticLMStream, build_stream

__all__ = ["DataConfig", "SyntheticLMStream", "build_stream"]
