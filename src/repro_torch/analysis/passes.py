"""The five contract passes, counterpart of ``repro/analysis/passes.py``
(``docs/static_analysis_torch.md`` has what each means eagerly).

Each pass is ``fn(specs) -> (findings, n_checked)`` registered in
``framework.PASSES``. The program passes read each spec's one recorded
run (``ProgramSpec.recording``); host-purity reads source only.
"""
from __future__ import annotations

import ast
import os
from typing import List, Sequence

import torch

from .framework import (
    Finding,
    ProgramSpec,
    arg_signature,
    materialized_shapes,
    register_pass,
)

# ---------------------------------------------------------------------------
# 1. materialization — forbidden intermediate shapes
# ---------------------------------------------------------------------------


@register_pass("materialization")
def materialization_pass(specs: Sequence[ProgramSpec]):
    """No recorded op of a spec with ``forbid`` rules may take or give a
    tensor matching any rule: the (m × S) Soft-MoE plane (PAPER.md §2's
    linear-memory claim) and the (B, blocks·block_size) paged row view
    are both instances of this one predicate. A kernel wrapper is one op
    (its inputs and outputs), plus on the card the buffers it allocates."""
    findings: List[Finding] = []
    n = 0
    for spec in specs:
        if not spec.forbid:
            continue
        n += 1
        ops = spec.ops()
        for rule in spec.forbid:
            shapes = materialized_shapes(ops, rule)
            if shapes:
                findings.append(Finding(
                    "materialization", spec.label,
                    f"{rule.label} materialized: shapes {shapes}",
                ))
    return findings, n


# ---------------------------------------------------------------------------
# 2. retrace — one argument signature per program under churn
# ---------------------------------------------------------------------------


@register_pass("retrace")
def retrace_pass(specs: Sequence[ProgramSpec]):
    """Every churn variant of a program's arguments must have the base
    call's signature (pytree structure, per tensor (shape, dtype), Python
    scalars by type). The port runs eagerly and compiles nothing, so
    nothing recompiles today; this is the precondition for capturing each
    program once in a CUDA graph (ROADMAP's host-bound serving lever):
    churn changes VALUES, never signatures."""
    findings: List[Finding] = []
    n = 0
    for spec in specs:
        if not spec.churn:
            continue
        n += 1
        base = arg_signature(spec.args)
        for i, variant in enumerate(spec.churn):
            sig = arg_signature(variant)
            if sig != base:
                diffs = _signature_diff(base, sig)
                findings.append(Finding(
                    "retrace", spec.label,
                    f"churn variant {i} changes the argument signature "
                    f"({diffs}) — a program captured once would "
                    "recompile (re-capture) under churn",
                ))
    return findings, n


def _signature_diff(a, b) -> str:
    if a[0] != b[0]:
        return "pytree structure differs"
    out = []
    for j, (la, lb) in enumerate(zip(a[1], b[1])):
        if la != lb:
            out.append(f"leaf {j}: {la} -> {lb}")
    return "; ".join(out) or "unknown"


# ---------------------------------------------------------------------------
# 3. donation — pool buffers are updated in place
# ---------------------------------------------------------------------------


@register_pass("donation")
def donation_pass(specs: Sequence[ProgramSpec]):
    """The eager meaning of the reference's donation: every argnum in
    ``spec.donate`` is updated IN PLACE. Read from the recorded run: no
    tensor leaf of the argument may end up bound to other storage
    (``untyped_storage().data_ptr()``), and the program must have written
    the argument in place (some leaf's ``_version`` moved) or handed its
    own storage back as its result, as a donated buffer aliases the
    reference's output (a pool program with nothing to do, say clearing
    attention blocks of an attention-free arch, returns its cache as it
    is). A program that builds its result in fresh memory, by rebinding a
    leaf or by returning a new cache and leaving the old one as it was,
    would hold two copies of the pool, which is what a missing
    ``donate_argnums`` costs the reference. A leaf the program need not
    touch stays as it is (the K/V of a block whose ``pos`` a clear
    program resets)."""
    findings: List[Finding] = []
    n = 0
    for spec in specs:
        if not spec.donate:
            continue
        n += 1
        in_place = spec.recording().in_place
        for argnum in spec.donate:
            rec = in_place[argnum]
            if rec.rebound:
                findings.append(Finding(
                    "donation", spec.label,
                    f"argnum {argnum} not donated: {len(rec.rebound)}/"
                    f"{rec.n_leaves} leaves rebound to new storage (e.g. "
                    f"{rec.rebound[0]}) — not updated in place",
                ))
            elif rec.n_leaves and not (rec.written or rec.returned):
                findings.append(Finding(
                    "donation", spec.label,
                    f"argnum {argnum} not donated: 0/{rec.n_leaves} leaves "
                    "written in place or returned — the program leaves "
                    "the buffer as it was",
                ))
    return findings, n


# ---------------------------------------------------------------------------
# 4. dtype — accumulation dtype discipline
# ---------------------------------------------------------------------------

# floating reductions: jnp's softmax and log_softmax lower to reduce_max +
# reduce_sum, so the fused torch ops count too
_REDUCE_OPS = {
    "sum", "mean", "amax", "amin", "prod", "cumsum", "logsumexp",
    "cummax", "cummin", "_softmax", "_log_softmax",
}
_REDUCE_OVERLOADED = {"max", "min"}  # reductions only as .dim / .default
_DOT_OPS = {"mm", "bmm", "addmm", "baddbmm", "linear"}


def _is_dot(op: str) -> bool:
    return op in _DOT_OPS or op.startswith("_scaled_dot_product_")


def _is_reduction(name: str) -> bool:
    op, _, overload = name.partition(".")
    return op in _REDUCE_OPS or (op in _REDUCE_OVERLOADED
                                 and overload in ("dim", "default"))


@register_pass("dtype")
def dtype_pass(specs: Sequence[ProgramSpec]):
    """Accumulation regions must agree with the declared ``acc_dtype``:

    * every floating-point reduction (sum / mean / max / min / prod /
      cumulative / logsumexp / softmax) must accumulate in exactly
      ``acc_dtype``, read from its ``dtype=`` keyword where given, else
      from its output: a bf16 reduction is a silent precision loss, an
      f64 one a silent upcast;
    * no matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``linear``,
      ``_scaled_dot_product_*``) may emit a dtype narrower than its
      widest floating operand.

    ``dtype_policy="dots_only"`` skips the reduction rule (a backward's
    cotangent sums follow the forward's compute dtype). Kernel calls are
    skipped: the kernels accumulate in float32 by their own contract
    (``KernelConfig.acc_dtype``, checked at launch)."""
    findings: List[Finding] = []
    n = 0
    for spec in specs:
        if spec.dtype_policy == "skip":
            continue
        n += 1
        acc = getattr(torch, spec.acc_dtype)
        reduce_bad = {}
        dot_bad = {}
        for op in spec.ops():
            if op.name.startswith("kernel."):
                continue
            if _is_reduction(op.name) and spec.dtype_policy == "strict":
                dt = op.dtype_kw or next(
                    (d for _, d in op.outputs if d.is_floating_point), None)
                if dt is not None and dt.is_floating_point and dt != acc:
                    key = (op.op, str(dt).replace("torch.", ""))
                    reduce_bad[key] = reduce_bad.get(key, 0) + 1
            elif _is_dot(op.op):
                fl = [d for _, d in op.inputs if d.is_floating_point]
                out_dt = op.outputs[0][1] if op.outputs else None
                if (fl and out_dt is not None and out_dt.is_floating_point
                        and out_dt.itemsize < max(d.itemsize for d in fl)):
                    key = (op.op, str([str(d).replace("torch.", "")
                                       for d in fl]),
                           str(out_dt).replace("torch.", ""))
                    dot_bad[key] = dot_bad.get(key, 0) + 1
        for (name, dt), count in sorted(reduce_bad.items()):
            word = ("downcast" if getattr(torch, dt).itemsize < acc.itemsize
                    else "upcast")
            findings.append(Finding(
                "dtype", spec.label,
                f"{count}× {name} accumulates in {dt} ({word}), declared "
                f"acc_dtype is {spec.acc_dtype}",
            ))
        for (name, operands, out_dt), count in sorted(dot_bad.items()):
            findings.append(Finding(
                "dtype", spec.label,
                f"{count}× {name} {operands} -> {out_dt} discards "
                "accumulated precision below its widest operand",
            ))
    return findings, n


# ---------------------------------------------------------------------------
# 5. host-purity — AST lint over serve-side python
# ---------------------------------------------------------------------------

_SYNC_METHODS = {"item", "synchronize"}
_IMPORT_TIME_COMPILE = {"torch.compile", "torch.jit.script",
                        "torch.jit.trace"}
_IMPORT_TIME_BACKEND = {"torch.cuda.is_available", "torch.cuda.device_count",
                        "torch.cuda.get_device_name",
                        "torch.cuda.current_device"}


def _dotted(node) -> str:
    """'torch.compile' for Attribute(Name('torch'), 'compile'); '' if not
    a plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class _HostPurityVisitor(ast.NodeVisitor):
    """The reference's three rules over one file, mapped to torch:

    R1 anywhere: no host syncs, ``.item()`` and ``.synchronize()``
       (``torch.cuda.synchronize``, a stream's or an event's). Either
       inside the engine tick serializes the device pipeline; the
       telemetry drain is the one sanctioned sync point (allowlisted,
       not exempted here). ``.cpu()`` / ``.numpy()`` are the counterpart
       of the reference's ``np.asarray`` fetch of the sampled tokens,
       which it does not flag either.
    R2 import scope: no ``torch.compile`` / ``torch.jit.script`` /
       ``torch.jit.trace`` outside function bodies, as a call or as a
       decorator: an import-scope compile builds before any config
       exists and pins its choices for every later caller.
    R3 import scope: no device probes (``torch.cuda.is_available()``,
       ``device_count()``, ``get_device_name()``, ``current_device()``)
       outside function bodies: an import-time global freezes the
       device choice at import order.
    """

    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self.depth = 0  # function nesting; 0 == import scope

    def _flag(self, node, msg):
        self.findings.append(Finding(
            "host-purity", f"{self.path}:{node.lineno}", msg
        ))

    def visit_FunctionDef(self, node):
        # decorators run at the enclosing scope: @torch.compile (bare, as
        # a call or through functools.partial) on a module-level def
        # compiles at import
        if self.depth == 0:
            for dec in node.decorator_list:
                hit = next((_dotted(sub) for sub in ast.walk(dec)
                            if _dotted(sub) in _IMPORT_TIME_COMPILE), None)
                if hit:
                    self._flag(dec, f"{hit} at import scope (decorator)")
                    break
        for dec in node.decorator_list:
            self.visit(dec)
        node.decorator_list = []
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1

    def visit_Call(self, node):
        name = _dotted(node.func)
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _SYNC_METHODS:
                self._flag(node, f".{attr}() is a host sync")
        if self.depth == 0:
            if name in _IMPORT_TIME_COMPILE:
                self._flag(node, f"{name} at import scope")
            elif name in _IMPORT_TIME_BACKEND:
                self._flag(
                    node,
                    f"{name}() at import scope freezes the backend "
                    "choice at import time",
                )
        self.generic_visit(node)


def host_purity_findings(paths: Sequence[str]) -> List[Finding]:
    """Run the host-purity AST lint over explicit file paths (the
    fixture-facing entry; the registered pass lints the serve stack)."""
    findings: List[Finding] = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        rel = os.path.relpath(path, _repo_root()) \
            if os.path.isabs(path) else path
        visitor = _HostPurityVisitor(rel)
        visitor.visit(tree)
        findings.extend(visitor.findings)
    return findings


def _repo_root() -> str:
    # src/repro_torch/analysis/passes.py -> repo root
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "..")
    )


def serve_side_sources() -> List[str]:
    """The host-purity scan surface: the engine and serving modules plus
    the kernel layer."""
    root = _repo_root()
    out = []
    for sub in ("src/repro_torch/serve", "src/repro_torch/kernels"):
        d = os.path.join(root, sub)
        out.extend(
            os.path.join(d, f) for f in sorted(os.listdir(d))
            if f.endswith(".py")
        )
    return out


@register_pass("host-purity")
def host_purity_pass(specs: Sequence[ProgramSpec]):
    paths = serve_side_sources()
    return host_purity_findings(paths), len(paths)
