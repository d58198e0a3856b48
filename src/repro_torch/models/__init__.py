from repro_torch.models.transformer import (
    Mamba2,
    MoETransformer,
    Transformer,
    build_model,
    chunked_lm_loss,
    lm_loss,
)

__all__ = ["Mamba2", "MoETransformer", "Transformer", "build_model", "chunked_lm_loss", "lm_loss"]
