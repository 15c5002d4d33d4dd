"""Static invariant audit of the PyTorch / CUDA port.

Five analyzers, one contract: ``python -m repro_torch.audit`` exits 0 iff
every statically checkable invariant the bit-identity guarantees rest on
holds (stale-waiver *warnings* print but never fail the run).  The names
and the contract are the reference's (``repro.audit``) less its ``jitkey``
— the port keeps no program cache, so there are no keys to audit; what
two of them check is the port's own:

* :mod:`.registry` — registry / Table-I completeness of
  ``repro_torch.core.oplib`` and the planner's matrix.
* :mod:`.intwidth` — integer-width abstract interpretation under a declared
  envelope, the per-scheme safe-size table, and the cross-check of the
  stream's runtime capacity guard.
* :mod:`.tracesafety` (``trace``) — the host-sync lint: ``.item()``,
  ``.cpu()``, casts, stringification and ``Tensor.__bool__`` branches in
  lowering rules, fused rules and every function that calls the lowering.
* :mod:`.kernelspec` — CUDA launch grids: the symbolic specs of
  :mod:`repro_torch.kernels.specs` proved in bounds and exactly-once for
  every grid shape, shared memory within the card's limits, the staged
  unpack windows, the output-multiply lint over ``csrc/*.cu``, kernel and
  launch sites, ``constexpr`` drift and the ``ctypes`` launcher signatures.
* :mod:`.sharddisjoint` — shard-partition exactness and the int16
  collective bit budget, with a per-world safe-size table.
"""
from .findings import SCHEMA_VERSION, AuditReport, Finding
from .intwidth import DEFAULT_ENVELOPE, Envelope, analyze_int_width, safe_size_table
from .kernelspec import analyze_kernel_specs, check_unpack_lemma
from .registry import analyze_registry
from .runner import ALL_ANALYZERS, main, run_audit
from .sharddisjoint import analyze_shard_disjoint, shard_safe_size_table
from .tracesafety import analyze_trace_safety

__all__ = [
    "AuditReport", "Finding", "SCHEMA_VERSION", "Envelope",
    "DEFAULT_ENVELOPE", "ALL_ANALYZERS",
    "analyze_registry", "analyze_int_width", "safe_size_table",
    "analyze_trace_safety", "analyze_kernel_specs",
    "check_unpack_lemma", "analyze_shard_disjoint", "shard_safe_size_table",
    "run_audit", "main",
]
