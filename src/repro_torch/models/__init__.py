"""Model zoo: the transformer family (dense, MoE, VLM) behind one
functional facade."""
from .zoo import Model, get_model, input_specs, make_batch

__all__ = ["Model", "get_model", "input_specs", "make_batch"]
