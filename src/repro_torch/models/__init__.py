"""Model zoo: the transformer (dense, MoE, VLM), Mamba, Griffin and Whisper
families behind one functional facade."""
from .zoo import Model, get_model, input_specs, make_batch

__all__ = ["Model", "get_model", "input_specs", "make_batch"]
