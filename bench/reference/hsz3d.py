"""Plain reference of the 3-D curl: the paper's §V-C.3 vector curl

    curl(u, v, w) = (dw/dy - dv/dz, du/dz - dw/dx, dv/dx - du/dy)

with (x, y, z) = axes (0, 1, 2), on full rank-3 fields.  Every other op on
a rank-3 field is ``hsz.py``'s, whose rules hold at any rank; its curl is
the 2-D one.

As in ``hsz.py``, a central difference along an axis is ``(q[i + 1] -
q[i - 1]) * eps`` on the common interior (one element off each end of
every axis), from each field's quantization integers ``q`` and its own
``eps``, computed in float64, so exact but for one rounding.  With
``dtype=torch.bfloat16`` every step runs in bfloat16 instead: the control.
"""
from __future__ import annotations

import torch


def derivative(q: torch.Tensor, eps, axis: int, dtype=torch.float64):
    """The central difference along ``axis`` on the common interior."""
    def shifted(shift: int) -> torch.Tensor:
        idx = [slice(1, n - 1) for n in q.shape]
        idx[axis] = slice(1 + shift, q.shape[axis] - 1 + shift)
        return q[tuple(idx)]
    return (shifted(1) - shifted(-1)).to(dtype) * eps.to(dtype)


def curl(fields, dtype=torch.float64) -> tuple[torch.Tensor, ...]:
    """The three components of the curl of ``(u, v, w)``, each given as
    ``(q, eps)`` of a rank-3 field."""
    if len(fields) != 3 or any(q.ndim != 3 for q, _ in fields):
        raise ValueError("the 3-D curl takes three rank-3 components")
    (u, eu), (v, ev), (w, ew) = fields
    return (derivative(w, ew, 1, dtype) - derivative(v, ev, 2, dtype),
            derivative(u, eu, 2, dtype) - derivative(w, ew, 0, dtype),
            derivative(v, ev, 0, dtype) - derivative(u, eu, 1, dtype))
