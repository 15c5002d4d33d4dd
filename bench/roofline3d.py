"""The least bytes a request needs on fields of any rank: ``roofline.py``'s
rule for the Lorenzo predictor, box by box.

A request's least bytes are the packed payload bits of the residuals its
answer depends on (``values × bits``, in whole bytes), the one 4-byte
anchor of each field read, and the answer written once (4 bytes a value).
A Lorenzo integer ``q[i]`` is the sum of the residuals in its prefix box
``[0, i]``, so:

* a window statistic depends on the prefix box of the window;
* an axis-``a`` difference on the window's interior, ``q[i + e_a] -
  q[i - e_a]``, sums the residuals from index ``lo_a + 1`` to ``hi_a - 1``
  along ``a`` and from 0 up to ``hi_k - 2`` along every other axis ``k``:
  the box ``[lo_a + 1, hi_a) × [0, hi_k - 1)``;
* a field differentiated along several axes (a gradient, a Laplacian, a
  curl component) is read once, over the union of their boxes.

A vector operator counts each component with the axes it is
differentiated along: divergence component ``a`` along ``a``; the 3-D curl
(``(dw/dy - dv/dz, du/dz - dw/dx, dv/dx - du/dy)``) ``u`` along (1, 2),
``v`` along (0, 2), ``w`` along (0, 1); the 2-D curl ``u`` along 1, ``v``
along 0.  On a rank-2 field every count equals ``roofline.py``'s.
"""
from __future__ import annotations

import itertools
import math

Box = tuple[tuple[int, int], ...]


def _volume(box: Box) -> int:
    return math.prod(max(b - a, 0) for a, b in box)


def _meet(boxes) -> Box:
    return tuple((max(a for a, _ in sides), min(b for _, b in sides))
                 for sides in zip(*boxes))


def union_volume(boxes: list[Box]) -> int:
    """Elements in the union of axis-aligned boxes (inclusion-exclusion)."""
    total = 0
    for k in range(1, len(boxes) + 1):
        for subset in itertools.combinations(boxes, k):
            total += (-1) ** (k + 1) * _volume(_meet(subset))
    return total


def difference_box(window: Box, axis: int) -> Box:
    """The residuals an axis-``axis`` difference on the window's interior
    depends on."""
    return tuple((lo + 1, hi) if k == axis else (0, hi - 1)
                 for k, (lo, hi) in enumerate(window))


def component_axes(op: str, rank: int, components: int) -> list[tuple[int, ...]]:
    """The axes each field of a request is differentiated along."""
    if op == "divergence":
        return [(a,) for a in range(components)]
    if op == "curl":
        return [(1, 2), (0, 2), (0, 1)] if components == 3 else [(1,), (0,)]
    return [tuple(range(rank))]     # gradient, laplacian


def _field_bytes(boxes: list[Box], bits: int) -> int:
    return -(-union_volume(boxes) * bits // 8) + 4


def _answer_values(op: str, window: Box, components: int) -> int:
    if op in ("mean", "std"):
        return 1
    interior = math.prod(max(hi - lo - 2, 0) for lo, hi in window)
    if op == "gradient":
        return len(window) * interior
    if op == "curl" and components == 3:
        return 3 * interior
    return interior


def least_bytes(scheme: str, op: str, shape, *, bits, window: Box | None = None,
                axis: int = 0) -> int:
    """Least bytes of one request over Lorenzo fields of ``shape``; ``bits``
    is the payload's packed width, or one width per component field."""
    if not scheme.startswith("hszp"):
        raise ValueError("the box count is the Lorenzo predictor's")
    w = window if window is not None else tuple((0, n) for n in shape)
    widths = tuple(bits) if isinstance(bits, (tuple, list)) else (bits,)
    if op in ("mean", "std"):
        read = _field_bytes([tuple((0, hi) for _, hi in w)], widths[0])
    elif op == "derivative":
        read = _field_bytes([difference_box(w, axis)], widths[0])
    else:
        read = sum(_field_bytes([difference_box(w, a) for a in axes], b)
                   for axes, b in zip(component_axes(op, len(w), len(widths)),
                                      widths))
    return read + 4 * _answer_values(op, w, len(widths))
