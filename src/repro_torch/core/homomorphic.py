"""Homomorphic analytical operations on intermediate representations (paper §V).

Seven operations, three categories:

* statistics — ``mean`` (stages ①②③④, ① HSZx-family only), ``std`` (②③④);
* numerical differentiation — ``derivative``, ``gradient``, ``laplacian``
  (② nd-schemes, ③④ all);
* multivariate derivation — ``divergence``, ``curl`` (same stage support).

Every operation is a thin wrapper over :mod:`repro_torch.core.oplib`, and
runs on the device its container lives on.  All stencil operators return the
*common interior* of the field (every axis cropped by one at each end).
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from . import oplib
from .stages import Compressed, Encoded, Stage

Field = Compressed | Encoded

#: fused lowering entry point (see :func:`repro_torch.core.oplib.compute`).
compute = oplib.compute


def mean(c: Field, stage: Stage) -> torch.Tensor:
    """Field mean at a given decompression stage."""
    return oplib.compute(c, "mean", stage)["mean"]


def std(c: Field, stage: Stage) -> torch.Tensor:
    """Sample standard deviation at a given stage (paper §V-A.2)."""
    return oplib.compute(c, "std", stage)["std"]


def derivative(c: Field, stage: Stage, axis: int) -> torch.Tensor:
    """Central difference along ``axis`` on the common interior (III-B.2)."""
    return oplib.compute(c, "derivative", stage, axis=axis)["derivative"]


def gradient(c: Field, stage: Stage) -> tuple:
    """All-axis central differences sharing one stage reconstruction."""
    return oplib.compute(c, "gradient", stage)["gradient"]


def laplacian(c: Field, stage: Stage) -> torch.Tensor:
    """2nd-order Laplacian stencil on the common interior (III-B.3)."""
    return oplib.compute(c, "laplacian", stage)["laplacian"]


def divergence(components: Sequence[Field], stage: Stage) -> torch.Tensor:
    """div F = sum_a  d(F_a)/d(x_a)  on the common interior (V-C.1/2)."""
    return oplib.compute(list(components), "divergence", stage)["divergence"]


def curl(components: Sequence[Field], stage: Stage):
    """2-D: scalar dv/dx - du/dy (paper V-C.3 with (x,y)=(axis0,axis1));
    3-D: the full vector curl."""
    return oplib.compute(list(components), "curl", stage)["curl"]
