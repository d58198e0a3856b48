from repro_torch.models.transformer import Transformer, build_model, lm_loss

__all__ = ["Transformer", "build_model", "lm_loss"]
