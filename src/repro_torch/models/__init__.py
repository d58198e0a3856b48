from repro_torch.models.transformer import (
    Hybrid,
    Mamba2,
    MoETransformer,
    Transformer,
    VisionLM,
    build_model,
    chunked_lm_loss,
    lm_loss,
)

__all__ = ["Hybrid", "Mamba2", "MoETransformer", "Transformer", "VisionLM", "build_model",
           "chunked_lm_loss", "lm_loss"]
