"""The least bytes a request needs, and the device peak they are set against.

A request's least bytes are the bytes of the cheapest stage that can give
its answer, read once, plus the answer written once:

* a stage-① mean (block-mean predictor, whole blocks): the block means of
  the blocks in the window, 4 bytes each;
* anything else: the packed payload bits of the residuals the answer
  depends on (``values × bits``, in whole bytes), the metadata of the
  blocks they lie in (block-mean predictor: 4 bytes a block; Lorenzo: its
  one 4-byte anchor), and the answer (4 bytes a value).

Which residuals an answer depends on follows from the predictor alone, so
the count is the same whatever implements the request: a Lorenzo integer
``q[i, j]`` is the sum of the residuals in the prefix rectangle up to
``(i, j)``, so a window statistic depends on the prefix hull of the window
and an axis-0 difference on a band of rows; a block-mean integer is its own
residual plus its block's mean.  A vector operator counts each component
field with the axis it is differentiated along.  All counts are 2-D.
"""
from __future__ import annotations

#: NVIDIA H100 SXM5 HBM3 bandwidth, data sheet figure (bytes per second)
HBM_BYTES_PER_S = 3.35e12

Rect = tuple[tuple[int, int], tuple[int, int]]


def _area(rect: Rect) -> int:
    (r0, r1), (c0, c1) = rect
    return max(r1 - r0, 0) * max(c1 - c0, 0)


def _meet(a: Rect, b: Rect) -> Rect:
    return tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))


def _blocks(rect: Rect, block) -> int:
    """Blocks of the grid that ``rect`` touches."""
    n = 1
    for (a, b), s in zip(rect, block):
        if b <= a:
            return 0
        n *= (b - 1) // s - a // s + 1
    return n


def dependency(scheme: str, op: str, window: Rect, axis: int = 0) -> list[Rect]:
    """The rectangles of residuals that ``op`` on ``window`` depends on
    (disjoint but for an overlap that :func:`least_bytes` takes out once).

    ``op`` is one scalar op: ``mean``, ``std``, ``derivative`` (with
    ``axis``), ``gradient`` or ``laplacian``."""
    (r0, r1), (c0, c1) = window
    lorenzo = scheme.startswith("hszp")
    if op in ("mean", "std"):
        return [((0, r1), (0, c1))] if lorenzo else [window]
    if lorenzo:
        # q[i+1, j] - q[i-1, j] sums the residuals of rows i, i + 1 up to
        # column j; the interior's rows are r0 + 1 .. r1 - 2
        band = {0: ((r0 + 1, r1), (0, c1 - 1)), 1: ((0, r1 - 1), (c0 + 1, c1))}
    else:
        band = {0: ((r0, r1), (c0 + 1, c1 - 1)), 1: ((r0 + 1, r1 - 1), (c0, c1))}
    if op == "derivative":
        return [band[axis]]
    if op in ("gradient", "laplacian"):
        return [band[0], band[1]]
    raise ValueError(f"no dependency rule for {op!r}")


def _field_bytes(scheme: str, op: str, window: Rect, axis: int, bits: int,
                 block) -> int:
    rects = dependency(scheme, op, window, axis)
    values = sum(_area(r) for r in rects)
    meta_blocks = sum(_blocks(r, block) for r in rects)
    if len(rects) == 2:
        both = _meet(*rects)
        values -= _area(both)
        meta_blocks -= _blocks(both, block)
    meta = 4 * meta_blocks if scheme.startswith("hszx") else 4
    return -(-values * bits // 8) + meta


def _result_values(op: str, window: Rect) -> int:
    (r0, r1), (c0, c1) = window
    interior = max(r1 - r0 - 2, 0) * max(c1 - c0 - 2, 0)
    if op in ("mean", "std"):
        return 1
    return 2 * interior if op == "gradient" else interior


def least_bytes(scheme: str, op: str, shape, *, bits, block,
                window: Rect | None = None, axis: int = 0) -> int:
    """Least bytes of one request over fields of ``shape``: ``op`` at its
    cheapest stage.  ``bits`` is the payload's packed width, or one width
    per component field of a vector operator."""
    w = window if window is not None else tuple((0, n) for n in shape)
    width = bits if isinstance(bits, (tuple, list)) else (bits,) * len(shape)
    if op == "mean" and scheme.startswith("hszx") and all(
            a % b == 0 and (c % b == 0 or c == n)
            for (a, c), b, n in zip(w, block, shape)):
        return 4 * _blocks(w, block) + 4
    if op == "divergence":
        # component a differentiated along axis a
        read = sum(_field_bytes(scheme, "derivative", w, a, width[a], block)
                   for a in range(2))
    elif op == "curl":
        # dv/dx0 - du/dx1
        read = (_field_bytes(scheme, "derivative", w, 0, width[1], block)
                + _field_bytes(scheme, "derivative", w, 1, width[0], block))
    else:
        read = _field_bytes(scheme, op, w, axis, width[0], block)
    return read + 4 * _result_values(op, w)


def least_seconds(total_bytes: int) -> float:
    """The least time ``total_bytes`` take at the device's memory rate."""
    return total_bytes / HBM_BYTES_PER_S
