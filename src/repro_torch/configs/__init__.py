from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke

__all__ = ["ARCHS", "ModelConfig", "RunConfig", "get_config", "get_smoke"]
