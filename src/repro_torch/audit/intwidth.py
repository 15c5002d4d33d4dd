"""Analyzer (2): integer-width abstract interpretation.

Every bit-identity guarantee in this reproduction rides on int32 arithmetic
that must not wrap *meaningfully*: quantization indices, Lorenzo /
block-mean residuals, bit-packed payload words, the stage-② integer sum
accumulators, and the streaming :class:`~repro_torch.core.oplib.TemporalSummary`
``{count, Σq, Σq²}`` leaves.  Two of these were once fixed reactively
(payload bit accounting and ``compression_ratio`` past 2^26 elements); this
pass proves the rest *statically* by propagating value-range intervals
through the pipeline:

    quantize → (Lorenzo diffs | block-mean residuals) → zigzag/bitpack
             → stage-② sum accumulators → TemporalSummary {count, Σq, Σq²}

under a declared :class:`Envelope` (``|q| ≤ 2^q_bits − 1``, maximum field
size, maximum appended timesteps).  Violations — an accumulator whose
worst-case magnitude exceeds int32 under the envelope — are findings; the
per-scheme maximum safe field size / slab count is emitted as a
machine-readable table (``AUDIT.json``, ``safe_size_table()``) and is the
source of the runtime guard
``repro_torch.stream.temporal.summary_capacity``
(checked here for presence and agreement).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.stages import Scheme

from .findings import Finding

_ANALYZER = "intwidth"

INT32_MAX = 2**31 - 1
UINT32_MAX = 2**32 - 1
#: f32 integer-exactness horizon: sums beyond 2^24 lose exactness (not an
#: overflow — reported in the table, never as a finding).
F32_EXACT = 2**24

#: largest block configured by the pipeline (DEFAULT_BLOCKS: 256 / 16×16 /
#: 8×8×8 — all 256 elements; callers may configure up to this).
MAX_BLOCK_ELEMS = 4096


# ---------------------------------------------------------------------------
# interval domain
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Interval:
    """Closed integer interval [lo, hi] — the abstract value domain."""

    lo: int
    hi: int

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @classmethod
    def sym(cls, mag: int) -> "Interval":
        """Symmetric interval [-mag, mag]."""
        return cls(-mag, mag)

    @property
    def mag(self) -> int:
        return max(abs(self.lo), abs(self.hi))

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def __sub__(self, other: "Interval") -> "Interval":
        return Interval(self.lo - other.hi, self.hi - other.lo)

    def __mul__(self, other: "Interval") -> "Interval":
        ps = (self.lo * other.lo, self.lo * other.hi,
              self.hi * other.lo, self.hi * other.hi)
        return Interval(min(ps), max(ps))

    def square(self) -> "Interval":
        if self.lo <= 0 <= self.hi:
            lo = 0
        else:
            lo = min(self.lo * self.lo, self.hi * self.hi)
        return Interval(lo, max(self.lo * self.lo, self.hi * self.hi))

    def sum_n(self, n: int) -> "Interval":
        """Worst-case sum of ``n`` independent values from this interval."""
        return Interval(self.lo * n, self.hi * n)

    def fits_int32(self) -> bool:
        return -INT32_MAX - 1 <= self.lo and self.hi <= INT32_MAX

    def zigzag(self) -> "Interval":
        """u = (p << 1) ^ (p >> 31): unsigned magnitude-ordered image."""
        return Interval(0, 2 * self.mag)


# ---------------------------------------------------------------------------
# operating envelope
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Envelope:
    """Declared operating envelope the deployment promises to stay inside.

    ``q_bits``
        magnitude bits of the quantization indices: ``|q| ≤ 2^q_bits − 1``.
        With the value-range-relative bound ``eps = rel_eb · range`` this is
        ``q_bits = ceil(log2(1 / (2 · rel_eb)))`` — e.g. ``rel_eb = 1e-4``
        gives ``q_bits = 13``.
    ``max_field_elems``
        largest spatial field (elements) queried at any stage.
    ``max_slab_steps``
        most timesteps ever appended to one temporal stream.
    """

    q_bits: int = 12
    max_field_elems: int = 2**17
    max_slab_steps: int = 128

    @property
    def q_abs(self) -> int:
        return 2**self.q_bits - 1


DEFAULT_ENVELOPE = Envelope()


def summary_capacity(q_abs: int) -> int:
    """Max timesteps an int32 :class:`TemporalSummary` holds exactly when
    every index satisfies ``|q| ≤ q_abs`` — the binding constraint is the
    ``Σq²`` leaf (``T · q_abs² ≤ 2^31 − 1``), then ``Σq``, then ``count``.

    This is THE capacity formula: ``repro_torch.stream.temporal.
    summary_capacity``
    must agree (checked by :func:`analyze_int_width`), and the runtime guard
    in ``TemporalField.append`` enforces it against the *measured* per-slab
    ``|q|`` bound, so long-stream appends fail loudly instead of wrapping.
    """
    q_abs = int(q_abs)
    if q_abs < 0:
        raise ValueError(f"negative |q| bound: {q_abs}")
    if q_abs == 0:
        return INT32_MAX  # all-zero stream: only the count leaf can wrap
    return min(INT32_MAX // (q_abs * q_abs), INT32_MAX // q_abs, INT32_MAX)


# ---------------------------------------------------------------------------
# per-scheme pipeline propagation
# ---------------------------------------------------------------------------

def _ndim(scheme: Scheme) -> int:
    """Worst-case rank the scheme's decorrelation runs over (1-D schemes
    flatten; nd schemes support up to 3 axes)."""
    return 3 if Scheme(scheme).is_nd else 1


def pipeline_bounds(scheme: Scheme, env: Envelope) -> dict:
    """Propagate intervals through one scheme's pipeline; returns the named
    accumulator table ``{name: {"interval": Interval, "dtype", "limit",
    "max_field_elems"/"max_steps"}}`` the findings and the safe-size table
    both read."""
    scheme = Scheme(scheme)
    q = Interval.sym(env.q_abs)
    n = env.max_field_elems
    acc: dict[str, dict] = {}

    def int32_acc(name: str, interval: Interval, **extra):
        acc[name] = {"interval": interval, "dtype": "int32",
                     "limit": INT32_MAX, **extra}

    # quantize: int32 indices
    int32_acc("quantize.q", q)

    # decorrelate
    if scheme.is_blockmean:
        # block mean: int32 sum of <= MAX_BLOCK_ELEMS indices, then divide
        int32_acc("decorrelate.block_sum", q.sum_n(MAX_BLOCK_ELEMS))
        mean = q  # rounded mean of values in q's interval stays inside it
        p = q - mean                      # residual = q - M_b
    else:
        # Lorenzo: one first-difference per axis doubles the magnitude
        p = q
        for _ in range(_ndim(scheme)):
            p = p - q if p is q else Interval.sym(2 * p.mag)
        p = Interval.sym((2 ** _ndim(scheme)) * env.q_abs)
    int32_acc("decorrelate.residual", p)

    # zigzag / bitpack: uint32 plane; width <= 32 by construction
    u = p.zigzag()
    acc["encode.zigzag"] = {"interval": u, "dtype": "uint32",
                            "limit": UINT32_MAX}

    # recorrelation (stage ③ reconstruction) is exact by inverse identity:
    # cumsum(p) == q, so the reconstructed indices live back in q's interval
    int32_acc("recorrelate.q", q)

    # stage-②/① integer sum accumulators (core.oplib lowering rules)
    if scheme.is_blockmean:
        meta_sum = q.sum_n(n)             # _mean_m: sum M_b * overlap_b
        int32_acc("oplib.mean_m.metadata_sum", meta_sum,
                  max_field_elems=INT32_MAX // max(q.mag, 1))
        res_sum = p.sum_n(n)              # _mean_p_blockmean: masked_sum(p)
        int32_acc("oplib.mean_p.residual_sum", res_sum,
                  max_field_elems=INT32_MAX // max(p.mag, 1))
        tot = meta_sum + res_sum          # _std_p_blockmean: tot = s + Σ p_win
        int32_acc("oplib.std_p.window_sum", tot,
                  max_field_elems=INT32_MAX // max(q.mag + p.mag, 1))
    # Lorenzo stage-② statistics contract through f32 (weighted dots /
    # stat_values) — no int32 field-sized accumulator; exactness horizon
    # F32_EXACT is reported in the table, not a finding.

    # temporal summaries (core.oplib.summary_from_q / merge_summaries)
    t = env.max_slab_steps
    int32_acc("temporal.count", Interval(0, t), max_steps=INT32_MAX)
    int32_acc("temporal.q_sum", q.sum_n(t),
              max_steps=INT32_MAX // max(q.mag, 1))
    int32_acc("temporal.q_sumsq", q.square().sum_n(t),
              max_steps=INT32_MAX // max(q.mag * q.mag, 1))
    return acc


def safe_size_table(env: Envelope = DEFAULT_ENVELOPE) -> dict:
    """Machine-readable per-scheme safe sizes under ``env`` (the table
    ``AUDIT.json`` carries)."""
    table: dict[str, dict] = {"envelope": {
        "q_bits": env.q_bits, "q_abs": env.q_abs,
        "max_field_elems": env.max_field_elems,
        "max_slab_steps": env.max_slab_steps,
        "f32_exact_horizon": F32_EXACT,
    }}
    for scheme in Scheme:
        acc = pipeline_bounds(scheme, env)
        field_caps = [v["max_field_elems"] for v in acc.values()
                      if "max_field_elems" in v]
        step_caps = [v["max_steps"] for v in acc.values()
                     if "max_steps" in v]
        table[scheme.value] = {
            "residual_abs_max": acc["decorrelate.residual"]["interval"].mag,
            "max_safe_field_elems": min(field_caps, default=INT32_MAX),
            "max_safe_slab_steps": min(step_caps, default=INT32_MAX),
            "summary_capacity": summary_capacity(env.q_abs),
            "accumulators": {
                name: {"lo": v["interval"].lo, "hi": v["interval"].hi,
                       "dtype": v["dtype"],
                       "headroom_bits": (
                           math.floor(math.log2(v["limit"] / v["interval"].mag))
                           if v["interval"].mag else 32)}
                for name, v in acc.items()},
        }
    return table


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _probe_payload_accounting() -> list[Finding]:
    """Semantic probe: the serialized-size accounting must accumulate in
    floating point (int32 payload-bit sums wrap past 2^31 bits), and
    ``compression_ratio`` must compute ``n * 32`` in float (int32 wraps for
    fields >= 2^26 elements).  Runs the port's own functions on CPU
    tensors."""
    import types

    import torch

    from ..core import encode
    from ..core.pipeline import hszx

    out = []
    bits = encode.serialized_bits(torch.full((4,), 16, dtype=torch.int32),
                                  torch.full((4,), 256, dtype=torch.int32),
                                  meta_bits_per_block=32)
    if not torch.is_floating_point(torch.as_tensor(bits)):
        out.append(Finding(
            _ANALYZER, "payload-bits-overflow",
            "encode.serialized_bits accumulates payload bits in "
            f"{torch.as_tensor(bits).dtype}; int accumulation wraps past "
            "2^31 bits (~1e8 elements at 16 bits/value)",
            subject="encode.serialized_bits",
            suggestion="sum payload bits in f32"))

    # a field of 2^27 elements at 32 bits/value: int32 n*32 would wrap
    fake = types.SimpleNamespace(
        n=2**27, bitwidths=torch.full((4,), 16, dtype=torch.int32),
        valid_counts=torch.full((4,), 256, dtype=torch.int32),
        scheme=Scheme.HSZX)
    ratio = float(hszx.compression_ratio(fake))
    expected = (2**27 * 32.0) / float(hszx.serialized_bits(fake))
    if not (ratio > 0 and abs(ratio - expected) < 1e-3 * expected):
        out.append(Finding(
            _ANALYZER, "ratio-overflow",
            f"compression_ratio computes {ratio} for a 2^27-element field "
            f"(expected {expected:.1f}); the original-bits product is "
            "wrapping in integer arithmetic",
            subject="pipeline.compression_ratio",
            suggestion="compute original bits as float(n) * 32.0"))
    return out


def _check_runtime_guard() -> list[Finding]:
    """The streaming satellite of this analyzer: ``repro_torch.stream.
    temporal`` must expose the capacity formula and enforce it on append."""
    out = []
    try:
        from ..stream import temporal
    except Exception as e:  # noqa: BLE001 - report, don't crash the audit
        return [Finding(
            _ANALYZER, "unguarded-accumulator",
            f"repro_torch.stream.temporal failed to import ({e!r}); cannot verify "
            "the TemporalSummary capacity guard",
            subject="stream.temporal")]
    guard = getattr(temporal, "summary_capacity", None)
    if guard is None or getattr(temporal, "SummaryCapacityError", None) is None:
        out.append(Finding(
            _ANALYZER, "unguarded-accumulator",
            "repro_torch.stream.temporal has no summary_capacity / "
            "SummaryCapacityError: int32 TemporalSummary accumulators can "
            "wrap silently on long streams",
            subject="stream.temporal.summary_capacity",
            suggestion="enforce the audited capacity in TemporalField.append"))
        return out
    for q_abs in (0, 1, 255, 4095, 2**15, 2**20):
        if guard(q_abs) != summary_capacity(q_abs):
            out.append(Finding(
                _ANALYZER, "guard-mismatch",
                f"stream.temporal.summary_capacity({q_abs}) = "
                f"{guard(q_abs)} but the audited bound is "
                f"{summary_capacity(q_abs)}",
                subject="stream.temporal.summary_capacity",
                suggestion="derive the runtime guard from the audited "
                           "formula (one source of truth)"))
            break
    return out


def analyze_int_width(env: Envelope = DEFAULT_ENVELOPE, *,
                      probe_runtime: bool = True) -> list[Finding]:
    """Run the int-width pass: interval propagation per scheme under
    ``env`` plus (when ``probe_runtime``) the semantic accounting probes
    and the runtime-guard presence check."""
    findings: list[Finding] = []
    for scheme in Scheme:
        for name, v in pipeline_bounds(scheme, env).items():
            iv: Interval = v["interval"]
            if iv.mag > v["limit"] or (v["dtype"] == "int32"
                                       and not iv.fits_int32()):
                invariant = ("sumsq-overflow" if name.endswith("q_sumsq")
                             else "sum-overflow" if "sum" in name
                             else "width-overflow")
                findings.append(Finding(
                    _ANALYZER, invariant,
                    f"{scheme.value}: accumulator {name} spans "
                    f"[{iv.lo}, {iv.hi}] — exceeds {v['dtype']} under the "
                    f"declared envelope (|q| ≤ {env.q_abs}, "
                    f"N ≤ {env.max_field_elems}, T ≤ {env.max_slab_steps})",
                    subject=name,
                    suggestion="shrink the envelope (max field size / slab "
                               "count / q_bits) or widen the accumulator"))
    if probe_runtime:
        findings.extend(_probe_payload_accounting())
        findings.extend(_check_runtime_guard())
    return findings
