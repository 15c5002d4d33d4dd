"""The port's static invariant audit (``repro_torch.audit``) against the
reference's (``repro.audit``), class by class of ``tests/test_audit.py``.

What is held:

* **Mirrored** (the reference's contract on the port): registry and
  intwidth fixtures, the runner and CLI (exit 0 iff no error finding,
  warnings never fail, ``--only``, schema version 2), registration-time
  validation in ``repro_torch.core.oplib.register_op``, the stream's
  summary-capacity guard, a clean self-audit in both kernel modes.  The
  port registers the reference's analyzers less ``jitkey``: it keeps no
  program cache, so there are no keys to audit.
* **Rewritten** for torch and CUDA: each known-bad fixture — a hidden
  ``.item()`` in a lowering rule, an ``if`` on a tensor, a host copy in a
  function that calls the lowering, a widened halo, overlapping tile writes, a coverage gap, static shared
  memory over 48 KiB, a ``PAD`` too small, a float ``*`` stored to an
  output, an undeclared ``__global__``, a stale spec, a ``constexpr``
  drift, a ``SIGNATURES`` arity or width mismatch, a double-owned payload
  word, a Σq² overflow — gives exactly one finding of its invariant, and
  its corrected twin none.
* **Parity with the reference, exactly**: ``safe_size_table``,
  ``shard_safe_size_table`` and ``pipeline_bounds`` for the default
  envelope and two others; ``bit_budget`` / ``worst_case_psum`` for worlds
  1–4096; the ``(analyzer, invariant)`` pairs of the registry and intwidth
  sabotage fixtures in both packages.
* **The CPU prover against the CPU plain versions**: at the edge shapes of
  every tiling limit, each instantiation's spec reaches every output
  element exactly once and names the extents the plain version's output
  has; the spec's facts hold at those launches.  The kernels themselves are
  checked on the card (``chip_smoke.py`` phase 7; the ``gpu`` test below).
"""
import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.audit import intwidth as jintwidth
from repro.audit import registry as jregistry
from repro.audit import sharddisjoint as jsharddisjoint
from repro.comm import hom_collectives as jhc
from repro.core import Scheme as JScheme
from repro.core import Stage as JStage
from repro.core.oplib import OpSpec as JOpSpec
from repro_torch import audit
from repro_torch.audit import (intwidth, kernelspec, registry, runner,
                               sharddisjoint, tracesafety)
from repro_torch.audit.findings import SCHEMA_VERSION, AuditReport, Finding
from repro_torch.comm import hom_collectives as hc
from repro_torch.core import encode, oplib
from repro_torch.core.oplib import OpSpec
from repro_torch.core.stages import Scheme, Stage
from repro_torch.kernels import bitpack, build, fused, ops, prefix_stats
from repro_torch.kernels import quant_lorenzo, specs, stencil_dq
from repro_torch.kernels.block_stats import block_stats_plain
from repro_torch.shard import exec as shard_exec
from repro_torch.shard.placement import BlockPlacement
from repro_torch.stream import temporal as ttemporal
from repro_torch.stream.temporal import (SummaryCapacityError, TemporalField,
                                         summary_capacity)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
INT32_MAX = 2**31 - 1

#: the default envelope and two others (the parity tables' inputs)
ENVELOPES = {"default": {}, "wide": {"q_bits": 15, "max_field_elems": 2**20,
                                     "max_slab_steps": 2},
             "long": {"q_bits": 8, "max_field_elems": 2**12,
                      "max_slab_steps": 4096}}


def _env(pkg, name):
    return pkg.Envelope(**ENVELOPES[name])


def _field_spec(cls, name, *, feasible, lower, closure="default"):
    if closure == "default":
        closure = lambda s, st, a: "cover"  # noqa: E731
    return cls(name=name, arity="field", category="statistic",
               feasible=feasible, closure=closure, lower=lower)


def _only_hszp_at_f(scheme_cls, stage_cls):
    def feasible(scheme):
        s = scheme_cls(scheme)
        return (stage_cls.F,) if (s.is_lorenzo and not s.is_nd) else ()
    return feasible


def _registry_fixtures(cls, scheme_cls, stage_cls):
    """The reference's registry sabotage fixtures, built in one package."""
    rule = lambda ctx, axis: None  # noqa: E731
    feas = _only_hszp_at_f(scheme_cls, stage_cls)
    F = stage_cls.F
    return {
        "missing-cell": ({"badop": _field_spec(cls, "badop", feasible=feas,
                                               lower={})}, {}),
        "shadowed-any": ({"shadow": _field_spec(
            cls, "shadow", feasible=feas,
            lower={(F, "lorenzo"): rule, (F, "any"): rule})}, {}),
        "missing-closure": ({"noclose": _field_spec(
            cls, "noclose", feasible=feas, lower={(F, "any"): rule},
            closure=None)}, {}),
        "collision": ({"dup": _field_spec(cls, "dup", feasible=feas,
                                          lower={(F, "any"): rule})},
                      {"dup": cls(name="dup", arity="temporal",
                                  category="statistic",
                                  feasible=lambda s: (stage_cls.Q,),
                                  lower_temporal=lambda s, e: None)}),
    }


def _pairs(findings):
    return sorted((f.analyzer, f.invariant) for f in findings)


@pytest.fixture(scope="module")
def live_report():
    """One self-audit of the port per kernel mode (the slowest analyzer
    parses every CUDA source)."""
    out = {}
    for mode in ("on", "off"):
        with ops.override_mode(mode):
            out[mode] = audit.run_audit()
    return out


# ===========================================================================
# analyzer (1): registry completeness
# ===========================================================================

class TestRegistryAnalyzer:
    def _fixtures(self):
        return _registry_fixtures(OpSpec, Scheme, Stage)

    def test_missing_lowering_cell_one_finding(self):
        fs = registry.analyze_registry(*self._fixtures()["missing-cell"],
                                       check_matrix=False)
        assert len(fs) == 1
        (f,) = fs
        assert f.invariant == "missing-lowering-rule"
        assert "(stage F, lorenzo)" in f.message

    def test_shadowed_any_rule_one_finding(self):
        fs = registry.analyze_registry(*self._fixtures()["shadowed-any"],
                                       check_matrix=False)
        assert [f.invariant for f in fs] == ["ambiguous-lowering-rule"]

    def test_missing_closure_one_finding(self):
        fs = registry.analyze_registry(*self._fixtures()["missing-closure"],
                                       check_matrix=False)
        assert [f.invariant for f in fs] == ["missing-closure"]

    def test_registry_collision_detected(self):
        fs = registry.analyze_registry(*self._fixtures()["collision"],
                                       check_matrix=False)
        assert [f.invariant for f in fs] == ["registry-collision"]

    def test_live_registries_clean(self):
        assert registry.analyze_registry() == []

    @pytest.mark.parametrize("fixture", ["missing-cell", "shadowed-any",
                                         "missing-closure", "collision"])
    def test_same_pairs_as_reference(self, fixture):
        port = registry.analyze_registry(
            *_registry_fixtures(OpSpec, Scheme, Stage)[fixture],
            check_matrix=False)
        ref = jregistry.analyze_registry(
            *_registry_fixtures(JOpSpec, JScheme, JStage)[fixture],
            check_matrix=False)
        assert port and _pairs(port) == _pairs(ref)


# ===========================================================================
# analyzer (2): integer-width abstract interpretation
# ===========================================================================

class TestIntWidthAnalyzer:
    def test_default_envelope_clean(self):
        assert intwidth.analyze_int_width(probe_runtime=False) == []

    def test_overflowing_sumsq_one_finding_per_scheme(self):
        env = intwidth.Envelope(max_slab_steps=129)  # 129 * 4095**2 > 2^31
        fs = intwidth.analyze_int_width(env, probe_runtime=False)
        assert len(fs) == len(list(Scheme))
        assert {f.invariant for f in fs} == {"sumsq-overflow"}
        assert {f.subject for f in fs} == {"temporal.q_sumsq"}

    def test_field_sum_overflow_detected(self):
        env = intwidth.Envelope(max_field_elems=2**21, max_slab_steps=1)
        fs = intwidth.analyze_int_width(env, probe_runtime=False)
        assert fs and {f.invariant for f in fs} == {"sum-overflow"}
        assert all("hszx" in f.message for f in fs)

    def test_safe_size_table_shape(self):
        table = intwidth.safe_size_table()
        for scheme in Scheme:
            row = table[scheme.value]
            assert row["max_safe_slab_steps"] >= 128
            assert row["summary_capacity"] == summary_capacity(4095)
            assert row["accumulators"]["temporal.q_sumsq"]["dtype"] == "int32"
        assert table["hszp_nd"]["residual_abs_max"] == 8 * 4095
        assert table["hszx"]["residual_abs_max"] == 2 * 4095

    def test_runtime_guard_probe_clean(self):
        assert intwidth.analyze_int_width() == []

    def test_interval_arithmetic(self):
        iv = intwidth.Interval.sym(10)
        assert (iv * iv).hi == 100
        assert iv.square().lo == 0
        assert iv.sum_n(3).mag == 30
        assert iv.zigzag() == intwidth.Interval(0, 20)
        with pytest.raises(ValueError):
            intwidth.Interval(1, 0)

    @pytest.mark.parametrize("env", sorted(ENVELOPES))
    def test_safe_size_table_equals_reference(self, env):
        assert intwidth.safe_size_table(_env(intwidth, env)) \
            == jintwidth.safe_size_table(_env(jintwidth, env))

    @pytest.mark.parametrize("env", sorted(ENVELOPES))
    @pytest.mark.parametrize("scheme", [s.value for s in Scheme])
    def test_pipeline_bounds_equal_reference(self, scheme, env):
        port = intwidth.pipeline_bounds(Scheme(scheme), _env(intwidth, env))
        ref = jintwidth.pipeline_bounds(JScheme(scheme), _env(jintwidth, env))
        assert list(port) == list(ref)
        for name in port:
            p, r = dict(port[name]), dict(ref[name])
            pi, ri = p.pop("interval"), r.pop("interval")
            assert (pi.lo, pi.hi) == (ri.lo, ri.hi)
            assert p == r

    @pytest.mark.parametrize("kw", [{"max_slab_steps": 129},
                                    {"max_field_elems": 2**21,
                                     "max_slab_steps": 1}])
    def test_sabotage_pairs_equal_reference(self, kw):
        port = intwidth.analyze_int_width(intwidth.Envelope(**kw),
                                          probe_runtime=False)
        ref = jintwidth.analyze_int_width(jintwidth.Envelope(**kw),
                                          probe_runtime=False)
        assert port and _pairs(port) == _pairs(ref)
        assert ([f.message for f in port] == [f.message for f in ref])

    def test_integer_payload_accounting_one_finding(self, monkeypatch):
        monkeypatch.setattr(
            encode, "serialized_bits",
            lambda bw, vc, **kw: (bw * vc).sum(dtype=torch.int32))
        fs = intwidth._probe_payload_accounting()
        assert "payload-bits-overflow" in [f.invariant for f in fs]

    def test_integer_ratio_one_finding(self, monkeypatch):
        from repro_torch.core.pipeline import HSZCompressor

        # n * 32 in int32 wraps to 0 at 2^27 elements
        monkeypatch.setattr(
            HSZCompressor, "compression_ratio",
            lambda self, c: (torch.tensor(c.n, dtype=torch.int32) * 32)
            .float() / self.serialized_bits(c))
        fs = intwidth._probe_payload_accounting()
        assert [f.invariant for f in fs] == ["ratio-overflow"]


# ===========================================================================
# analyzer (3): the host-sync lint
# ===========================================================================

_HIDDEN_ITEM = '''
import torch

def _mean_rule(ctx, axis):
    s = torch.sum(ctx.q_spatial)
    return s.item() / ctx.n
'''

_IF_ON_TENSOR = '''
import torch

def _std_rule(ctx, axis):
    s = torch.sum(ctx.q_spatial)
    if s > 0:
        return s
    return -s
'''

_WAIVED = '''
import torch

def _mean_rule(ctx, axis):
    s = torch.sum(ctx.q_spatial)
    return s.item()  # audit: waive(host-sync) deliberate for this test
'''

_CLEAN_RULE = '''
import torch

def _mean_rule(ctx, axis):
    if ctx.plan is not None and not ctx.plan.aligned:
        return None
    if ctx.scheme.is_nd and ctx.q_spatial.ndim == 2:
        n = int(ctx.q_spatial.shape[0]) * ctx.q_spatial.numel()
        return torch.sum(torch.ones(n))
    return torch.where(torch.zeros(()) > 0, 1.0, 0.0)
'''

_FUSED_VIA_HELPER = '''
import torch

class FusedRule:
    pass

def _covers(ctx):
    return True

def _rule(fn):
    return FusedRule(fn, _covers)

def _deriv(c, axis):
    out = torch.zeros(3)
    return float(out.sum())

CELLS = {"d": _rule(_deriv)}
'''

_PROGRAM_CACHE = '''
import torch

from ..core import oplib


class Engine:
    def run(self, fields, names, stage):
        out = oplib.compute(torch.stack(fields), names, stage)
        return out["mean"].item()

    def describe(self, fields):
        return torch.stack(fields).sum().item()
'''

_FSTRING = '''
import torch

def _rule(ctx, axis):
    s = torch.sum(ctx.q_spatial)
    print(f"sum={s}")
    return s
'''

_STRINGIFY = '''
import torch

def _rule(ctx, axis):
    s = torch.sum(ctx.q_spatial)
    a = str(s)
    b = format(s, ".3f")
    c = "{}".format(s)
    return s
'''

_STATIC_FSTRING = '''
def _rule(ctx, axis):
    print(f"shape={ctx.q_spatial.shape} on {ctx.q_spatial.device}")
    return ctx.q_spatial
'''

_STALE_WAIVE = '''
def _rule(ctx, axis):
    return ctx.q_spatial + 1  # audit: waive(host-sync)
'''

_BOOL_OP = '''
import torch

def _rule(ctx, axis):
    s = torch.sum(ctx.q_spatial)
    return (s > 0) and ctx.q_spatial
'''


class TestTraceSafetyAnalyzer:
    def test_hidden_item_in_lowering_rule_one_finding(self):
        fs = tracesafety.lint_source(_HIDDEN_ITEM, "fix.py")
        assert len(fs) == 1
        assert fs[0].invariant == "host-sync"
        assert fs[0].file == "fix.py" and fs[0].line == 6

    def test_if_on_tensor_one_finding(self):
        fs = tracesafety.lint_source(_IF_ON_TENSOR, "fix.py")
        assert [f.invariant for f in fs] == ["tracer-branch"]

    def test_corrected_twins_clean(self):
        fixed_item = _HIDDEN_ITEM.replace("s.item() / ctx.n", "s / ctx.n")
        fixed_if = _IF_ON_TENSOR.replace(
            "    if s > 0:\n        return s\n    return -s",
            "    return torch.where(s > 0, s, -s)")
        assert tracesafety.lint_source(fixed_item, "fix.py") == []
        assert tracesafety.lint_source(fixed_if, "fix.py") == []

    def test_waiver_comment_suppresses(self):
        assert tracesafety.lint_source(_WAIVED, "fix.py") == []

    def test_static_branches_not_flagged(self):
        assert tracesafety.lint_source(_CLEAN_RULE, "fix.py") == []

    @pytest.mark.parametrize("call", [".cpu()", ".numpy()", '.to("cpu")',
                                      ".tolist()",
                                      '.to(device=torch.device("cpu"))'])
    def test_device_to_host_copies_flagged(self, call):
        src = _HIDDEN_ITEM.replace(".item()", call)
        assert [f.invariant for f in tracesafety.lint_source(src, "f.py")] \
            == ["host-sync"]

    def test_fused_rule_through_helper_is_in_scope(self):
        fs = tracesafety.lint_source(_FUSED_VIA_HELPER, "fused.py")
        assert [(f.invariant, f.subject) for f in fs] \
            == [("host-sync", "_deriv")]

    def test_program_cache_closure_is_in_scope(self):
        """A function that calls the lowering is in scope; one that does
        not is not."""
        fs = tracesafety.lint_source(_PROGRAM_CACHE, "engine.py")
        assert [(f.invariant, f.subject) for f in fs] \
            == [("host-sync", "run")]

    def test_fstring_on_tensor_one_finding(self):
        fs = tracesafety.lint_source(_FSTRING, "fix.py")
        assert [f.invariant for f in fs] == ["host-sync"]

    def test_str_format_builtins_flagged(self):
        fs = tracesafety.lint_source(_STRINGIFY, "fix.py")
        assert [f.invariant for f in fs] == ["host-sync"] * 3

    def test_static_fstring_not_flagged(self):
        assert tracesafety.lint_source(_STATIC_FSTRING, "fix.py") == []

    def test_bool_op_on_tensor_flagged(self):
        fs = tracesafety.lint_source(_BOOL_OP, "fix.py")
        assert [f.invariant for f in fs] == ["tracer-branch"]

    def test_stale_waiver_is_warning_not_error(self):
        fs = tracesafety.lint_source(_STALE_WAIVE, "fix.py")
        assert [(f.invariant, f.severity) for f in fs] \
            == [("stale-waiver", "warning")]
        rep = AuditReport(findings=fs)
        assert rep.ok and rep.warnings and not rep.errors

    def test_repo_is_sync_free(self):
        assert tracesafety.analyze_trace_safety() == []

    def test_roots_are_the_references(self):
        from repro.audit import tracesafety as jtrace

        assert tracesafety._DEFAULT_ROOTS == jtrace._DEFAULT_ROOTS
        assert all((PKG / r).is_dir() for r in tracesafety._DEFAULT_ROOTS)

    def test_live_scope_covers_rules_fused_rules_and_programs(self):
        import ast as ast_mod

        names = {}
        for rel in ("core/oplib.py", "core/fused.py", "analytics/engine.py",
                    "shard/exec.py"):
            tree = ast_mod.parse((PKG / rel).read_text())
            idx = tracesafety._ScopeIndex(tree)
            idx.visit(tree)
            names[rel] = {getattr(r, "name", "<lambda>") for r in idx.roots}
        assert {"_mean_m", "_std_q", "_gradient_rule"} <= names["core/oplib.py"]
        assert {"_deriv_lorenzo", "_lap_blockmean_q"} <= names["core/fused.py"]
        # the functions that call the lowering (no program cache between)
        assert {"run", "run_expr", "summarize"} <= names["analytics/engine.py"]
        assert {"region_compute", "materialize"} <= names["shard/exec.py"]


# ===========================================================================
# analyzer (5): CUDA launch grids (kernelspec)
# ===========================================================================

_STENCIL = specs.spec("lorenzo_stencil_kernel<true, GRAD, INT32>")
_QUANT = specs.spec("quant_lorenzo2d_kernel")


def _replace_branch(spec, **kw):
    return replace(spec, branches=(replace(spec.branches[0], **kw),))


def _csrc_copy(tmp_path, names, edit=None):
    """A directory with copies of some sources (one edited)."""
    d = tmp_path / "csrc"
    d.mkdir()
    for name in names + ["common.cuh"]:
        text = (build.CSRC / name).read_text()
        if edit and name == edit[0]:
            assert edit[1] in text
            text = text.replace(edit[1], edit[2])
        (d / name).write_text(text)
    return d


_FMA = '''
__global__ void scale_kernel(const int* __restrict__ q, float eps,
                             float* __restrict__ out, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) out[i] = __int2float_rn(q[i]) * eps;
}

extern "C" int hsz_scale(const void* q, float eps, void* out, int n) {
  scale_kernel<<<(n + 255) / 256, 256>>>(
      static_cast<const int*>(q), eps, static_cast<float*>(out), n);
  return 0;
}
'''


def _lint(tmp_path, text):
    d = tmp_path / "lint"
    d.mkdir(exist_ok=True)
    (d / "k.cu").write_text(text)
    (d / "common.cuh").write_text((build.CSRC / "common.cuh").read_text())
    return kernelspec.lint_cuda_sources(kernelspec.load_sources(d))


class TestKernelSpecAnalyzer:
    def test_live_kernel_layer_clean(self, live_report):
        assert [f for f in live_report["on"].findings
                if f.analyzer == "kernelspec"] == []

    def test_every_instantiation_has_a_spec(self):
        srcs = kernelspec.load_sources(build.CSRC)
        names = [n for s in srcs for n, _ in s.table()]
        assert sorted(names) == sorted(specs.KERNEL_IDS)
        assert len(specs.KERNEL_IDS) == len(set(specs.KERNEL_IDS)) == 52
        globals_ = {(s.name, g) for s in srcs for g, _ in s.globals()}
        assert globals_ == {(s.source, s.function) for s in specs.KERNEL_SPECS}

    def test_every_pallas_site_is_replaced(self):
        # the rank-3 kernels name none: the reference declines rank 3
        replaced = {s.replaces for s in specs.KERNEL_SPECS if s.replaces}
        assert {s.source for s in specs.KERNEL_SPECS if not s.replaces} \
            == {"lorenzo3d.cu"}
        pallas = set()
        for py in sorted((ROOT / "src" / "repro" / "kernels").glob("*.py")):
            for i, line in enumerate(py.read_text().splitlines(), 1):
                if "pl.pallas_call(" in line:
                    pallas.add(py.name)
        assert {r.split(":")[0].rsplit("/", 1)[1] for r in replaced} == pallas

    def test_spec_is_clean(self):
        assert kernelspec.check_spec(_STENCIL) == []

    def test_widened_halo_one_finding(self):
        # the stencil pass stages rows i0 .. i0 + TH; reading one more row
        # of the staged window runs past it
        reads = tuple(
            replace(r, index=("r + 1", "c")) if r.array == "R" else r
            for r in _STENCIL.branches[0].reads)
        fs = kernelspec.check_spec(_replace_branch(_STENCIL, reads=reads))
        assert [f.invariant for f in fs] == ["halo-out-of-bounds"]

    def test_unguarded_global_halo_one_finding(self):
        reads = tuple(replace(r, guard=("", "<")) if r.array == "p" else r
                      for r in specs.spec(
                          "lorenzo_stencil_kernel<false, GRAD, INT32>")
                      .branches[0].reads)
        fs = kernelspec.check_spec(_replace_branch(
            specs.spec("lorenzo_stencil_kernel<false, GRAD, INT32>"), reads=reads))
        assert [f.invariant for f in fs] == ["halo-out-of-bounds"]

    def test_overlapping_tile_writes_one_finding(self):
        rows = specs.Cover(specs._d(("k", "1", "ROWS"), ("warp", "ROWS", "NWARP"),
                                    ("ti", "TH - 1", "n_rt")), "n0")
        writes = (specs.Write("out0", (rows, specs._TILE_COLS)),)
        fs = kernelspec.check_spec(_replace_branch(_STENCIL, writes=writes))
        assert [f.invariant for f in fs] == ["grid-write-overlap"]

    def test_write_race_one_finding(self):
        # every lane stores its warp's rows: lane is not in the index
        rows = specs.Cover(specs._d(("k", "1", "ROWS"), ("warp", "ROWS", "NWARP"),
                                    ("ti", "TH", "n_rt")), "n0")
        cols = specs.Cover(specs._d(("tj", "1", "n_ct")), "n_ct", clip=False)
        writes = (specs.Write("rowedge", (rows, cols)),)
        spec = specs.spec("lorenzo_edges_kernel<true>")
        fs = kernelspec.check_spec(_replace_branch(spec, writes=writes))
        assert [f.invariant for f in fs] == ["grid-write-overlap"]

    def test_coverage_gap_one_finding(self):
        lap = specs.spec("lorenzo_stencil_kernel<true, LAP, INT32>")
        fs = kernelspec.check_spec(replace(lap, facts=(
            "n0 == (n_rt - 1)*TH + e0 + TH", "n1 == (n_ct - 1)*TW + e1",
            "n_tiles == n_rt*n_ct")))
        assert [f.invariant for f in fs] == ["grid-write-gap"]

    def test_persistent_grid_larger_than_the_tiles_one_finding(self):
        # the prologue copies tile blockIdx.x: without grid <= n_tiles it
        # reads past the last tile
        spec = specs.spec("blockmean_kernel<true, GRAD>")
        bounds = dict(spec.bounds, G=("1", None))
        fs = kernelspec.check_spec(replace(spec, bounds=bounds))
        assert [f.invariant for f in fs] == ["halo-out-of-bounds"]

    def test_narrow_stats_past_4224_columns_one_finding(self):
        """The fault class that returned wrong sums right of column 4224:
        the narrow stats kernel reads 128 corner sums, so it covers a
        tile's corner only while n_ct <= 33."""
        spec = specs.spec("prefix_stats_tile_kernel<false>")
        bounds = dict(spec.bounds, n_ct=("1", None))
        fs = kernelspec.check_spec(replace(spec, bounds=bounds))
        assert [f.invariant for f in fs] == ["sum-gap"]

    def test_split_grid_partition_checked(self):
        spec = specs.spec("lorenzo_scan_kernel")
        bad = replace(spec, branches=(spec.branches[0], replace(
            spec.branches[1], start="n_rb + 1")))
        fs = kernelspec.check_spec(bad)
        assert [f.invariant for f in fs] == ["grid-write-gap"]

    def test_static_smem_over_48k_one_finding(self):
        fs = kernelspec.check_spec(replace(
            specs.spec("lorenzo_edges_kernel<false>"),
            smem_static="4*(3*TH*LD + NWARP*LDT)"))
        assert [f.invariant for f in fs] == ["smem-budget"]

    def test_total_smem_over_the_optin_limit_one_finding(self):
        fs = kernelspec.check_spec(replace(
            specs.spec("blockmean_kernel<false, LAP_P>"),
            smem_dynamic="4*(TILE*14 + HC + HR)"))
        assert [f.invariant for f in fs] == ["smem-budget"]

    def test_smem_drift_from_the_source_detected(self, tmp_path):
        d = _csrc_copy(tmp_path, ["lorenzo_band.cu"], (
            "lorenzo_band.cu", "__shared__ uint32_t S[SSEG][SCOLS];",
            "__shared__ uint32_t S[SSEG][SCOLS + 1];"))
        spec = specs.spec("lorenzo_scan_kernel")
        live = kernelspec.load_sources(build.CSRC)
        assert kernelspec._check_smem_source((spec,), live) == []
        fs = kernelspec._check_smem_source((spec,), kernelspec.load_sources(d))
        assert [f.invariant for f in fs] == ["smem-drift"]

    def test_unpack_lemma_pins_pad(self):
        assert kernelspec.check_unpack_lemma() == []
        assert kernelspec.min_unpack_pad() == 2
        fs = kernelspec.check_unpack_lemma(kernelspec.min_unpack_pad() - 1)
        assert [f.invariant for f in fs] == ["unpack-oob"]

    def test_band_staging_lemmas(self):
        assert kernelspec.check_lorenzo_staging() == []
        assert kernelspec.check_blockmean_staging() == []
        assert [f.invariant for f in kernelspec.check_lorenzo_staging(131)] \
            == ["unpack-oob"]
        assert kernelspec.check_blockmean_staging(128) == []
        assert [f.invariant for f in kernelspec.check_blockmean_staging(127)] \
            == ["unpack-oob"]

    def test_output_multiply_one_finding(self, tmp_path):
        fs = _lint(tmp_path, _FMA)
        assert [(f.invariant, f.line) for f in fs] == [("output-multiply", 5)]

    def test_explicit_fmul_allowed(self, tmp_path):
        fixed = _FMA.replace("__int2float_rn(q[i]) * eps",
                             "__fmul_rn(__int2float_rn(q[i]), eps)")
        assert _lint(tmp_path, fixed) == []

    def test_product_rounded_to_integer_allowed(self, tmp_path):
        rounded = _FMA.replace(
            "float* __restrict__ out", "int* __restrict__ out").replace(
            "out[i] = __int2float_rn(q[i]) * eps;",
            "out[i] = (int)rintf(__int2float_rn(q[i]) * eps);")
        assert _lint(tmp_path, rounded) == []

    def test_multiply_through_store_helper_detected(self, tmp_path):
        src = '''
#include "common.cuh"
__device__ __forceinline__ float scaled(int q, float e) {
  return __int2float_rn(q) * e;
}
__global__ void k(const int* __restrict__ q, float e, uint32_t* __restrict__ out, int n) {
  const int j = 4 * threadIdx.x;
  uint32_t o[4];
  for (int k = 0; k < 4; ++k) o[k] = __float_as_uint(scaled(q[j + k], e));
  hsz::store4(out, j, j, n, true, o);
}
'''
        fs = _lint(tmp_path, src)
        assert [(f.invariant, f.line) for f in fs] == [("output-multiply", 10)]

    def test_output_multiply_waiver_consumed_and_stale(self, tmp_path):
        waived = _FMA.replace("  if (i < n) out[i]",
                              "  // audit: waive(output-multiply)\n"
                              "  if (i < n) out[i]")
        assert _lint(tmp_path, waived) == []
        stale = waived.replace("__int2float_rn(q[i]) * eps",
                               "__fmul_rn(__int2float_rn(q[i]), eps)")
        fs = _lint(tmp_path, stale)
        assert [(f.invariant, f.severity) for f in fs] \
            == [("stale-waiver", "warning")]

    def test_live_sources_have_no_output_multiply(self):
        srcs = kernelspec.load_sources(build.CSRC)
        lint = kernelspec._MulLint(srcs)
        stores = list(lint.stores())
        assert any(s.name == "blockmean_band.cu" and f == "compute_store"
                   for s, f, _, _ in stores)  # store4 of the f32 laplacians
        assert kernelspec.lint_cuda_sources(srcs) == []

    def test_undeclared_kernel_one_finding(self, tmp_path):
        d = tmp_path / "mystery"
        d.mkdir()
        (d / "k.cu").write_text(_FMA.replace(" * eps", " + eps"))
        fs = kernelspec.analyze_kernel_specs(specs=(), csrc=d)
        assert [f.invariant for f in fs] == ["undeclared-kernel"]

    def test_stale_spec_one_finding(self, tmp_path):
        d = _csrc_copy(tmp_path, ["quant_lorenzo.cu"])
        fs = kernelspec.analyze_kernel_specs(
            specs=(_QUANT, replace(_QUANT, name="q2", function="gone_kernel")),
            csrc=d)
        assert [f.invariant for f in fs] == ["stale-kernel-spec"]

    def test_declared_twin_clean(self, tmp_path):
        d = _csrc_copy(tmp_path, ["quant_lorenzo.cu"])
        assert kernelspec.analyze_kernel_specs(
            specs=(_QUANT,), csrc=d, constants=specs.CONSTANTS,
            signatures={"hsz_quant_lorenzo2d":
                        build.SIGNATURES["hsz_quant_lorenzo2d"]}) == []

    def test_constexpr_drift_one_finding(self, tmp_path):
        d = _csrc_copy(tmp_path, ["quant_lorenzo.cu"], (
            "quant_lorenzo.cu", "constexpr int MAX_GRID_Y = 65535;",
            "constexpr int MAX_GRID_Y = 65534;"))
        fs = kernelspec.analyze_kernel_specs(specs=(_QUANT,), csrc=d,
                                             constants=specs.CONSTANTS)
        assert [(f.invariant, f.subject) for f in fs] \
            == [("constexpr-drift", "MAX_GRID_Y")]

    def test_kernel_ids_follow_the_tables(self):
        srcs = kernelspec.load_sources(build.CSRC)
        shuffled = specs.KERNEL_SPECS[1:] + specs.KERNEL_SPECS[:1]
        fs = kernelspec._check_tables(shuffled, srcs)
        assert [f.invariant for f in fs] == ["kernel-id-drift"]
        assert kernelspec._check_tables(specs.KERNEL_SPECS, srcs) == []

    def test_signatures_match_prototypes(self):
        srcs = kernelspec.load_sources(build.CSRC)
        assert kernelspec.check_signatures(build.SIGNATURES, srcs) == []
        assert set(kernelspec.prototypes(srcs)) == set(build.SIGNATURES)

    def test_signature_arity_mismatch_one_finding(self):
        import ctypes

        srcs = kernelspec.load_sources(build.CSRC)
        sigs = dict(build.SIGNATURES)
        sigs["hsz_pack"] = sigs["hsz_pack"][:-1]
        fs = kernelspec.check_signatures(sigs, srcs)
        assert [(f.invariant, f.subject) for f in fs] \
            == [("launcher-signature", "hsz_pack")]
        sigs = dict(build.SIGNATURES)
        sigs["hsz_unpack"] = (ctypes.c_void_p, ctypes.c_int) \
            + sigs["hsz_unpack"][2:]
        fs = kernelspec.check_signatures(sigs, srcs)
        assert [(f.invariant, f.subject) for f in fs] \
            == [("launcher-signature", "hsz_unpack")]

    def test_new_launchers_are_bound(self):
        import ctypes

        assert build.SIGNATURES["hsz_func_attrs"] == (ctypes.c_int,) + (
            ctypes.c_void_p,) * 4
        assert build.SIGNATURES["hsz_smem_optin"] == (ctypes.c_void_p,)

    def test_prover_slacks_do_not_cancel(self):
        """One slack variable per symbol: named by its index in the
        shrinking order list (as the reference's prover does), the slacks
        of ``b`` and ``m`` coincide and "prove" ``n*m - 1 - b >= 0`` for an
        unbounded ``b``."""
        P = kernelspec.Poly
        bounds = {"b": (P.const(0), None), "x": (P.const(0), P.const(3)),
                  "n": (P.const(1), None), "m": (P.const(1), None)}
        p = kernelspec.parse_expr("n*m - 1 - b")
        assert not kernelspec.prove_nonneg(p, ["b", "x", "n", "m"], bounds)
        bounds["b"] = (P.const(0), kernelspec.parse_expr("n*m - 1"))
        assert kernelspec.prove_nonneg(p, ["b", "x", "n", "m"], bounds)

    def test_prover_basics(self):
        p = kernelspec.parse_expr("(n - 1)*TH + e - 1", {"TH": 32})
        bounds = {"e": (kernelspec.Poly.const(1), kernelspec.Poly.const(32)),
                  "n": (kernelspec.Poly.const(1), None)}
        assert kernelspec.prove_nonneg(p, ["e", "n"], bounds)
        assert not kernelspec.prove_nonneg(
            kernelspec.parse_expr("n - 2"), ["n"], bounds)
        assert kernelspec.parse_expr("SPAN//32*bits", {"SPAN": 2048}) \
            == kernelspec.parse_expr("64*bits")


def _plain_extents(spec, args) -> dict[str, tuple]:
    """The output extents of the plain version the instantiation replaces,
    from the plain version itself at one launch's sizes."""
    if spec.edge_dims:
        return _plain_extents3(spec.name, args["n0"], args["n1"], args["n2"])
    n0, n1 = args["n0"], args["n1"]
    p = torch.zeros((n0, n1), dtype=torch.int32)
    name = spec.name
    if name.startswith("lorenzo_stencil"):
        what = {"DERIV0": "deriv0", "DERIV1": "deriv1", "GRAD": "grad",
                "LAP": "lap"}[name.split(", ")[1].rstrip(">")]
        out = fused.lorenzo_core(p, what)
        out = out if isinstance(out, tuple) else (out,)
        return {f"out{i}": tuple(o.shape) for i, o in enumerate(out)}
    if name.startswith("blockmean"):
        what = name.split(", ")[1].rstrip(">").lower()
        out = fused.blockmean_core(p, torch.zeros_like(p), (1, 1), what)
        out = out if isinstance(out, tuple) else (out,)
        return {f"out{i}": tuple(o.shape) for i, o in enumerate(out)}
    if name.startswith("lorenzo_edges") or name == "lorenzo_scan_kernel":
        r, c = fused.lorenzo_edge_prefixes_plain(p, (32, 128))
        return {"rowedge": tuple(r.shape), "coledge": tuple(c.shape)}
    if name == "corner_scan_kernel":
        r, c = fused.lorenzo_edge_prefixes_plain(p, (32, 128))
        corners = prefix_stats.corner_sums_plain(c, 32)
        return {"rowedge": tuple(r.shape), "coledge": tuple(c.shape),
                "corners": tuple(corners.shape)}
    if name == "prefix_stats_reduce_kernel":
        return {"out": (len(prefix_stats.prefix_stats2d_plain(p)),)}
    if name.startswith("prefix_stats_tile"):
        return {}  # per-block pairs: no plain counterpart
    if name == "quant_lorenzo2d_kernel":
        return {"p": tuple(quant_lorenzo.quant_lorenzo2d_plain(
            p.float(), 1.0).shape)}
    if name in ("grad2d_kernel", "laplacian2d_kernel"):
        if name == "grad2d_kernel":
            d0, d1 = stencil_dq.grad2d_int_plain(p)
            return {"d0": tuple(d0.shape), "d1": tuple(d1.shape)}
        return {"out": tuple(stencil_dq.laplacian2d_int_plain(p).shape)}
    if name == "block_stats_kernel":
        m, x = block_stats_plain(p)
        return {"means": tuple(m.shape), "maxu": tuple(x.shape)}
    raise KeyError(name)


@functools.cache
def _plain_extents3(name, n0, n1, n2) -> dict[str, tuple]:
    """``lorenzo3d.cu``: the plain version's interior (axis 0 for the axis-0
    kernel, 1 for the axis-1 one, 2 for the lane kernel), and the edge
    pass's (runs, n1 - 1, n2 - 2) sums of r above each run."""
    if name == "lorenzo3d_edges_kernel":
        return {"vedge": (-(-(n0 - 2) // specs.CONSTANTS["lorenzo3d.cu"]["RUN"]),
                          n1 - 1, n2 - 2)}
    axis = 2 if name == "lorenzo3d_lane_kernel" else int(name[-2])
    words = bitpack.pack_plain(torch.zeros(n0 * n1 * n2, dtype=torch.int32), 1)
    out = fused.lorenzo_enc3d_plain(words, (n0, n1, n2), (n0, n1, n2), 1, axis,
                                    torch.tensor(1.0))
    return {"out": tuple(out.shape)}


def _cover_launches(spec):
    cases = kernelspec.edge_launches(spec)
    cases = [a for a in cases if a.get("n0", 0) <= 33  # 65537 rows: below
             or spec.edge_dims]
    # the widest rank-3 interiors: below, in the facts alone
    cases = [a for a in cases if a.get("n1", 0) <= 19 or "n2" not in a]
    cases = [a for a in cases if a.get("n2", 0) <= 387]
    if spec.name == "prefix_stats_tile_kernel<false>":
        cases = [a for a in cases if 4 * (-(-a["n1"] // 128) - 1) <= 128]
    if spec.name == "prefix_stats_tile_kernel<true>":
        cases = [a for a in cases if 4 * (-(-a["n1"] // 128) - 1) > 128]
    return cases


class TestProverAgainstPlainVersions:
    """At the edge shapes, each instantiation's spec (the same data the
    prover reads) reaches every output element exactly once, and its
    extents are the extents of the plain version's outputs."""

    @pytest.mark.parametrize("name", specs.KERNEL_IDS)
    def test_concrete_coverage_matches_plain(self, name):
        spec = specs.spec(name)
        cases = _cover_launches(spec)
        assert cases
        for args in cases:
            assert kernelspec.check_launch(spec, args) == []
            cov = kernelspec.concrete_coverage(spec, args)
            for array, (extents, problems) in cov.items():
                assert problems == [], (name, args, array)
            if spec.source in ("unpack.cu", "pack.cu"):
                continue
            for array, extents in _plain_extents(spec, args).items():
                assert cov[array][0] == extents, (name, args, array)

    @pytest.mark.parametrize("name", ["unpack_kernel<false>",
                                      "unpack_kernel<true>", "pack_kernel"])
    def test_bitpack_extents_match_plain(self, name):
        spec = specs.spec(name)
        for n in (1, 2047, 2048, 2049, 4095, 4097, 14337):
            for bits in (1, 7, 16, 17, 31):
                words = bitpack.pack_plain(torch.zeros(n, dtype=torch.int32),
                                           bits)
                if name == "pack_kernel":
                    args = {"n": n, "n_words": words.shape[0]}
                    want = {"words": tuple(words.shape)}
                else:
                    args = {"n": n, "sms": 132, "per_sm": 8}
                    want = {"out": tuple(bitpack.unpack_plain(
                        words, n, bits).shape)}
                cov = kernelspec.concrete_coverage(spec, args)
                for array, extents in want.items():
                    assert cov[array] == (extents, [])

    def test_tall_planes_take_the_grid_stride_loop(self):
        for name, args in (("quant_lorenzo2d_kernel", {"n0": 65537, "n1": 3}),
                           ("grad2d_kernel", {"n0": 65539, "n1": 4})):
            spec = specs.spec(name)
            env = kernelspec.launch_symbols(spec, args)
            assert env["gy"] == 65535
            cov = kernelspec.concrete_coverage(spec, args)
            assert all(problems == [] for _, problems in cov.values())

    def test_sabotaged_spec_fails_concretely(self):
        bad = replace(_STENCIL, branches=(replace(
            _STENCIL.branches[0], writes=(specs.Write("out0", (
                specs.Cover(specs._d(("k", "1", "ROWS"),
                                     ("warp", "ROWS", "NWARP"),
                                     ("ti", "TH + 1", "n_rt")), "n0"),
                specs._TILE_COLS)),)),))
        cov = kernelspec.concrete_coverage(bad, {"n0": 97, "n1": 130,
                                                 "sms": 132, "per_sm": 4})
        assert cov["out0"][1]

    def test_launch_facts_checked_at_edge_launches(self):
        bad = replace(_QUANT, params=dict(_QUANT.params, gx="n1 // NT + 2"))
        fs = kernelspec._check_launches(bad)
        assert [f.invariant for f in fs] == ["spec-fact-violated"]


# ===========================================================================
# analyzer (6): shard-partition exactness
# ===========================================================================

class TestShardDisjointAnalyzer:
    def test_live_shard_layer_clean(self):
        assert sharddisjoint.analyze_shard_disjoint() == []

    def test_double_owned_word_one_finding(self):
        class DoubleOwned(BlockPlacement):
            def shard_word_index(self, bits):
                stripes = super().shard_word_index(bits)
                if self.n_shards >= 2 and len(stripes[0]):
                    stripes[1] = np.unique(np.concatenate(
                        [np.asarray(stripes[1]),
                         np.asarray(stripes[0][:1])]))
                return stripes

        fs = sharddisjoint.analyze_shard_disjoint(placement_cls=DoubleOwned)
        assert [f.invariant for f in fs] == ["word-owner-overlap"]

    def test_scatter_overlap_one_finding(self):
        def overlap_routing(n_shards, placement, bits, word_idx):
            src, dst = shard_exec.gather_routing(n_shards, placement, bits,
                                                 word_idx)
            src, dst = np.array(src), np.array(dst)
            if n_shards >= 2:
                l0 = np.nonzero(dst[0] != len(word_idx))[0]
                l1 = np.nonzero(dst[1] != len(word_idx))[0]
                if l0.size and l1.size:
                    dst[1, l1[0]] = dst[0, l0[0]]
            return src, dst

        fs = sharddisjoint.analyze_shard_disjoint(routing_fn=overlap_routing)
        assert [f.invariant for f in fs] == ["scatter-overlap"]

    def test_world_scaled_sumsq_overflow_one_finding(self):
        env = intwidth.Envelope(max_slab_steps=129)
        fs = sharddisjoint.analyze_shard_disjoint(env)
        assert [f.invariant for f in fs] == ["world-sumsq-overflow"]

    def test_collective_bit_budget_overflow_one_finding(self):
        fs = sharddisjoint.analyze_shard_disjoint(
            bit_budget_fn=lambda world, container_bits=16: 15)
        assert [f.invariant for f in fs] == ["collective-overflow"]

    def test_duplicated_band_detected(self):
        def dup_bands(field, placement, region=None):
            bands = shard_exec.spatial_bands(field, placement, region)
            return bands + bands[:1] if len(bands) > 1 else bands

        fs = sharddisjoint.analyze_shard_disjoint(bands_fn=dup_bands)
        assert fs and fs[0].invariant == "band-overlap"

    def test_safe_size_table_shape(self):
        per = sharddisjoint.shard_safe_size_table()["per_world"]
        assert per["1"]["summary_capacity_if_accumulating"] == 128
        caps = [per[str(w)]["summary_capacity_if_accumulating"]
                for w in (1, 2, 4, 8)]
        assert caps == sorted(caps, reverse=True)
        assert len({per[k]["summary_capacity_disjoint"] for k in per}) == 1
        for k in per:
            assert per[k]["collective_worst_psum"] <= hc.PSUM_CONTAINER_MAX

    @pytest.mark.parametrize("env", sorted(ENVELOPES))
    def test_shard_safe_size_table_equals_reference(self, env):
        assert sharddisjoint.shard_safe_size_table(_env(intwidth, env)) \
            == jsharddisjoint.shard_safe_size_table(_env(jintwidth, env))

    def test_bit_budget_equals_reference_for_every_world(self):
        assert hc.PSUM_CONTAINER_MAX == jhc.PSUM_CONTAINER_MAX
        for w in range(1, 4097):
            assert hc.bit_budget(w) == jhc.bit_budget(w)
            assert hc.worst_case_psum(w) == jhc.worst_case_psum(w)
            assert hc.worst_case_psum(w) <= hc.PSUM_CONTAINER_MAX

    def test_double_owned_word_same_pair_as_reference(self):
        from repro.shard.placement import BlockPlacement as JPlacement

        def double(base):
            class DoubleOwned(base):
                def shard_word_index(self, bits):
                    stripes = super().shard_word_index(bits)
                    if self.n_shards >= 2 and len(stripes[0]):
                        stripes[1] = np.unique(np.concatenate(
                            [np.asarray(stripes[1]),
                             np.asarray(stripes[0][:1])]))
                    return stripes
            return DoubleOwned

        port = sharddisjoint.analyze_shard_disjoint(
            placement_cls=double(BlockPlacement))
        ref = jsharddisjoint.analyze_shard_disjoint(
            placement_cls=double(JPlacement))
        assert _pairs(port) == _pairs(ref) == [("sharddisjoint",
                                                "word-owner-overlap")]


# ===========================================================================
# runner / CLI / self-audit
# ===========================================================================

class TestRunner:
    def test_self_audit_zero_findings(self, live_report):
        report = live_report["on"]
        assert report.ok, "\n".join(f.render() for f in report.findings)
        assert report.findings == []
        assert report.safe_sizes

    def test_cli_clean_exit_and_json(self, tmp_path, capsys):
        out = tmp_path / "AUDIT.json"
        rc = runner.main(["--json", str(out), "--only",
                          "registry,intwidth,trace,sharddisjoint"])
        assert rc == 0
        data = json.loads(out.read_text())
        assert data["ok"] and data["n_findings"] == 0
        assert set(data["safe_sizes"]) >= {s.value for s in Scheme}

    def test_cli_nonzero_on_findings(self, capsys):
        rc = runner.main(["--analyzer", "intwidth",
                          "--max-slab-steps", "129"])
        assert rc == 1
        assert "sumsq-overflow" in capsys.readouterr().out

    def test_report_round_trip(self):
        f = Finding("registry", "missing-lowering-rule", "msg", subject="op")
        rep = AuditReport(findings=[f])
        d = rep.to_dict()
        assert not d["ok"] and d["findings_by_analyzer"] == {"registry": 1}
        assert f.render().startswith("[registry/missing-lowering-rule]")

    def test_module_runs_without_jax_or_the_reference(self, tmp_path):
        """``python -m repro_torch.audit`` with jax and repro unimportable:
        the card's machine has neither."""
        out = tmp_path / "AUDIT.json"
        code = ("import sys, runpy; sys.modules['jax'] = None; "
                "sys.modules['repro'] = None; "
                "sys.argv = ['repro_torch.audit', '--json', sys.argv[1]]; "
                "runpy.run_module('repro_torch.audit', run_name='__main__')")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run([sys.executable, "-c", code, str(out)], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        data = json.loads(out.read_text())
        assert data["ok"] and data["n_errors"] == 0 and data["n_warnings"] == 0
        assert "audit clean" in proc.stdout


class TestRunnerContract:
    def test_six_analyzers_registered(self):
        """The reference's analyzers less ``jitkey`` (the port keeps no
        program cache), in the reference's order."""
        from repro.audit import runner as jrunner

        assert jrunner.ALL_ANALYZERS == (
            "registry", "intwidth", "trace", "jitkey", "kernelspec",
            "sharddisjoint")
        assert runner.ALL_ANALYZERS == tuple(
            a for a in jrunner.ALL_ANALYZERS if a != "jitkey")
        assert audit.ALL_ANALYZERS == runner.ALL_ANALYZERS

    def test_only_flag_and_schema_version(self, tmp_path, capsys):
        out = tmp_path / "AUDIT.json"
        rc = runner.main(["--only", "sharddisjoint,registry",
                          "--json", str(out)])
        assert rc == 0
        data = json.loads(out.read_text())
        assert data["schema_version"] == SCHEMA_VERSION == 2
        assert data["ok"] and data["shard_safe_sizes"]["per_world"]
        assert data["safe_sizes"] == {}  # intwidth did not run

    def test_only_rejects_unknown_analyzer(self, capsys):
        with pytest.raises(SystemExit) as exc:
            runner.main(["--only", "nosuch"])
        assert exc.value.code == 2

    def test_exit_zero_on_warnings_only(self, monkeypatch, capsys):
        rep = AuditReport(findings=[Finding(
            "trace", "stale-waiver", "m", severity="warning")])
        assert rep.ok and not rep.errors and len(rep.warnings) == 1
        d = rep.to_dict()
        assert d["ok"] and d["n_warnings"] == 1 and d["n_errors"] == 0
        monkeypatch.setattr(runner, "analyze_trace_safety", lambda: [Finding(
            "trace", "stale-waiver", "m", severity="warning")])
        assert runner.main(["--only", "trace"]) == 0
        assert "1 warning(s)" in capsys.readouterr().out

    def test_self_audit_clean_in_both_kernel_modes(self, live_report):
        for mode in ("on", "off"):
            report = live_report[mode]
            assert report.ok, (mode, [f.render() for f in report.findings])
            assert not report.warnings
            assert report.shard_safe_sizes["per_world"]

    def test_findings_schema_equals_reference(self):
        from repro.audit.findings import Finding as JFinding

        assert [f.name for f in dataclasses.fields(Finding)] \
            == [f.name for f in dataclasses.fields(JFinding)]


# ===========================================================================
# satellite: registration-time validation
# ===========================================================================

def _feas():
    return _only_hszp_at_f(Scheme, Stage)


class TestRegisterOpValidation:
    def test_rejects_missing_cell_naming_it(self):
        bad = _field_spec(OpSpec, "badreg", feasible=_feas(), lower={})
        with pytest.raises(ValueError, match=r"\(stage F, lorenzo\)"):
            oplib.register_op(bad)
        assert "badreg" not in oplib.OPS
        assert "badreg" not in oplib._ALL_OPS

    def test_rejects_missing_closure(self):
        rule = lambda ctx, axis: None  # noqa: E731
        bad = _field_spec(OpSpec, "badreg2", feasible=_feas(),
                          lower={(Stage.F, "any"): rule}, closure=None)
        with pytest.raises(ValueError, match="closure"):
            oplib.register_op(bad)
        assert "badreg2" not in oplib.OPS

    def test_rejects_temporal_without_rule(self):
        bad = OpSpec(name="badtemp", arity="temporal", category="statistic",
                     feasible=lambda s: (Stage.Q,))
        with pytest.raises(ValueError, match="lower_temporal"):
            oplib.register_op(bad)
        assert "badtemp" not in oplib.TEMPORAL_OPS

    def test_accepts_wellformed_spec(self):
        rule = lambda ctx, axis: None  # noqa: E731
        ok = _field_spec(OpSpec, "okreg_audit", feasible=_feas(),
                         lower={(Stage.F, "any"): rule})
        try:
            oplib.register_op(ok)
            assert "okreg_audit" in oplib.OPS
            assert registry.analyze_registry() == []
        finally:
            oplib.OPS.pop("okreg_audit", None)
            oplib._ALL_OPS.pop("okreg_audit", None)
            oplib._ORDER.pop("okreg_audit", None)


# ===========================================================================
# satellite: TemporalSummary capacity guard
# ===========================================================================

class TestSummaryCapacityGuard:
    def test_formula_matches_audit(self):
        for q_abs in (0, 1, 255, 4095, 4096, 2**15, 2**20):
            assert summary_capacity(q_abs) == intwidth.summary_capacity(q_abs)
            assert intwidth.summary_capacity(q_abs) \
                == jintwidth.summary_capacity(q_abs)
        assert summary_capacity(4095) == INT32_MAX // 4095**2 == 128
        assert summary_capacity(0) == INT32_MAX
        with pytest.raises(ValueError):
            summary_capacity(-1)

    def test_drifted_runtime_guard_one_finding(self, monkeypatch):
        monkeypatch.setattr(ttemporal, "summary_capacity",
                            lambda q: INT32_MAX // max(q, 1))
        fs = intwidth._check_runtime_guard()
        assert [f.invariant for f in fs] == ["guard-mismatch"]

    def test_missing_runtime_guard_one_finding(self, monkeypatch):
        monkeypatch.delattr(ttemporal, "SummaryCapacityError")
        fs = intwidth._check_runtime_guard()
        assert [f.invariant for f in fs] == ["unguarded-accumulator"]

    def test_append_fails_loudly_at_boundary(self):
        data = np.linspace(0.5, 1.0, 256, dtype=np.float32).reshape(1, 256)
        tf = TemporalField("hszx", eps=2**-16, device="cpu")
        tf.append(data)
        cap = summary_capacity(tf._q_abs_max)
        assert 1 <= cap <= 8, f"fixture drifted: capacity {cap}"
        while tf.n_steps < cap:
            tf.append(data)
        steps_before, n_slabs = tf.n_steps, tf.n_slabs
        with pytest.raises(SummaryCapacityError, match="capacity"):
            tf.append(data)
        assert tf.n_steps == steps_before and tf.n_slabs == n_slabs

    def test_normal_streams_unaffected(self):
        rng = np.random.default_rng(7)
        tf = TemporalField("hszp", rel_eb=1e-3, device="cpu")
        for _ in range(4):
            tf.append(rng.normal(size=(3, 64)).astype(np.float32))
        assert tf.n_steps == 12


# ===========================================================================
# on the card: phase 7 (c) of chip_smoke.py on a few shapes
# ===========================================================================

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_sentinel_coverage_on_card():
    """Every instantiation of a few edge shapes into guarded windows: every
    cell written once, no guard touched, bitwise the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cs = _chip_smoke()
    cs.RATES.update(cs.card_rates())
    cases = [("lorenzo", (33, 129), 7), ("lorenzo", (31, 4225), 17),
             ("blockmean", (33, 129), (1, 1), 7),
             ("blockmean", (32, 128), (4, 8), 31),
             ("entry", (33, 129)), ("entry", (65539, 4)),
             ("bitpack", 4097, 17), ("bitpack", 2047, 1),
             ("lorenzo3d", (20, 27, 33), 9, 3, (24, 32, 40))]
    covered = cs.check_coverage(0, cases)
    assert covered == set(specs.KERNEL_IDS)
    assert all(cs.specs.func_attrs(n)[3] >= 1 for n in specs.KERNEL_IDS)
