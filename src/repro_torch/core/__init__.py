"""HSZ compression core and homomorphic operations (PyTorch)."""
from . import encode, expr, homomorphic, oplib, region
from .error_analysis import (mean_bias_bound, reconstruction_bound,
                             std_bias_bound, stencil_bias_bound)
from .pipeline import (DEFAULT_BLOCKS, HSZCompressor, UnsupportedStageError,
                       by_name, hszp, hszp_nd, hszx, hszx_nd)
from .region import RegionPlan, normalize_region
from .stages import Compressed, Encoded, Scheme, Stage, layout_key

__all__ = [
    "Compressed", "DEFAULT_BLOCKS", "Encoded", "HSZCompressor", "RegionPlan",
    "Scheme", "Stage", "UnsupportedStageError", "by_name", "encode", "expr",
    "homomorphic", "hszp", "hszp_nd", "hszx", "hszx_nd", "layout_key",
    "mean_bias_bound", "normalize_region", "oplib", "reconstruction_bound",
    "region", "std_bias_bound", "stencil_bias_bound",
]
