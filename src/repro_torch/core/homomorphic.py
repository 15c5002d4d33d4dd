"""Homomorphic analytical operations on intermediate representations (paper §V).

Seven operations, three categories:

* statistics — ``mean`` (stages ①②③④, ① HSZx-family only), ``std`` (②③④);
* numerical differentiation — ``derivative``, ``gradient``, ``laplacian``
  (② nd-schemes, ③④ all);
* multivariate derivation — ``divergence``, ``curl`` (same stage support).

Every operation is a thin wrapper over :mod:`repro_torch.core.oplib`, and
runs on the device its container lives on.  All stencil operators return the
*common interior* of the field (every axis cropped by one at each end).

Every operation also accepts ``region=`` (per-axis ``(start, stop)``,
``slice`` or ``None`` over the original shape): the op then touches only the
blocks in the region's dependency closure (:mod:`repro_torch.core.region`)
and returns what the full-field op would return on the cropped decompressed
window — statistics over the window values, stencils on the window
interior.  The full-field path *is* the region path with ``region=None``.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from . import oplib
from . import region as R
from .stages import Compressed, Encoded, Stage

Field = Compressed | Encoded

#: fused lowering entry point (see :func:`repro_torch.core.oplib.compute`).
compute = oplib.compute


def mean(c: Field, stage: Stage,
         *, region: R.RegionSpec | None = None) -> torch.Tensor:
    """Field mean at a given decompression stage (optionally over a region)."""
    return oplib.compute(c, "mean", stage, region=region)["mean"]


def std(c: Field, stage: Stage,
        *, region: R.RegionSpec | None = None) -> torch.Tensor:
    """Sample standard deviation at a given stage (paper §V-A.2)."""
    return oplib.compute(c, "std", stage, region=region)["std"]


def derivative(c: Field, stage: Stage, axis: int,
               *, region: R.RegionSpec | None = None) -> torch.Tensor:
    """Central difference along ``axis`` on the common interior (III-B.2)."""
    return oplib.compute(c, "derivative", stage, axis=axis,
                         region=region)["derivative"]


def gradient(c: Field, stage: Stage,
             *, region: R.RegionSpec | None = None) -> tuple:
    """All-axis central differences sharing one stage reconstruction."""
    return oplib.compute(c, "gradient", stage, region=region)["gradient"]


def laplacian(c: Field, stage: Stage,
              *, region: R.RegionSpec | None = None) -> torch.Tensor:
    """2nd-order Laplacian stencil on the common interior (III-B.3)."""
    return oplib.compute(c, "laplacian", stage, region=region)["laplacian"]


def divergence(components: Sequence[Field], stage: Stage,
               *, region: R.RegionSpec | None = None) -> torch.Tensor:
    """div F = sum_a  d(F_a)/d(x_a)  on the common interior (V-C.1/2)."""
    return oplib.compute(list(components), "divergence", stage,
                         region=region)["divergence"]


def curl(components: Sequence[Field], stage: Stage,
         *, region: R.RegionSpec | None = None):
    """2-D: scalar dv/dx - du/dy (paper V-C.3 with (x,y)=(axis0,axis1));
    3-D: the full vector curl."""
    return oplib.compute(list(components), "curl", stage,
                         region=region)["curl"]
