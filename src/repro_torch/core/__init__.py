"""HSZ compression core and homomorphic operations (PyTorch)."""
from . import encode, homomorphic, oplib
from .error_analysis import (mean_bias_bound, reconstruction_bound,
                             std_bias_bound, stencil_bias_bound)
from .pipeline import (DEFAULT_BLOCKS, HSZCompressor, UnsupportedStageError,
                       by_name, hszp, hszp_nd, hszx, hszx_nd)
from .stages import Compressed, Encoded, Scheme, Stage

__all__ = [
    "Compressed", "DEFAULT_BLOCKS", "Encoded", "HSZCompressor", "Scheme",
    "Stage", "UnsupportedStageError", "by_name", "encode", "homomorphic",
    "hszp", "hszp_nd", "hszx", "hszx_nd", "mean_bias_bound", "oplib",
    "reconstruction_bound", "std_bias_bound", "stencil_bias_bound",
]
