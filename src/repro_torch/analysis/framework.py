"""Pass-registry core of the contract linter, counterpart of
``repro/analysis/framework.py`` (``docs/static_analysis_torch.md``).

A pass is a function ``(specs) -> (findings, n_checked)`` registered
under a name; a ``ProgramSpec`` describes ONE serving or training
program (the real callable harvested off a live engine, backend or
trainer, never a re-declaration that could drift) with example
arguments, churn variants, in-place expectations, forbidden shape
predicates and the declared accumulation dtype; an allowlist turns
intentional exceptions into recorded, reasoned findings.

The port compiles nothing, so there is no jaxpr to walk. Each program is
run ONCE, eagerly, on copies of its example arguments (the engine it
came from stays as it was) under ``OpRecorder``, a ``TorchDispatchMode``
that keeps every aten op the run dispatched, backward ops included when
the program differentiates. That recording is the port's
``iter_jaxprs``: ``materialized_shapes`` and the dtype pass read it, and
``ProgramSpec`` caches it as the reference caches ``jaxpr()``. A kernel
wrapper (``kernels/recording.py``) records as one op: the CUDA launch is
invisible to the dispatcher anyway, and on the CPU its plain version,
which forms the tiles the kernel keeps on chip, runs with the recorder
paused.
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import recording

# ---------------------------------------------------------------------------
# The one op recorder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpRecord:
    """One recorded op: ``name`` is ``"<op>.<overload>"`` for an aten op
    (``"sum.dim_IntList"``) or ``"kernel.<wrapper>"`` for a kernel call;
    ``inputs`` / ``outputs`` are ``(shape, dtype)`` pairs of its tensors;
    ``dtype_kw`` its ``dtype=`` keyword (None when not given); ``inplace``
    whether it wrote one of its inputs; ``within`` the kernel wrapper it
    ran inside (the kernel's own allocations on the card), else None."""

    name: str
    inputs: tuple
    outputs: tuple
    dtype_kw: Optional[torch.dtype] = None
    inplace: bool = False
    within: Optional[str] = None

    @property
    def op(self) -> str:
        return self.name.split(".")[0]

    def shapes(self):
        return [s for s, _ in self.inputs + self.outputs]


def _tensor_sig(tree) -> tuple:
    return tuple((tuple(t.shape), t.dtype)
                 for t in pytree.tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


def _writes_input(func) -> bool:
    """True iff the op's schema marks a positional argument as written
    (``add_``, ``copy_``, ``index_put_``, ...; ``out=`` buffers are
    keyword-only and are outputs)."""
    return any(a.alias_info is not None and a.alias_info.is_write
               and not a.kwarg_only for a in func._schema.arguments)


class OpRecorder(TorchDispatchMode):
    """``with OpRecorder() as rec: program()`` leaves every aten op the
    program dispatched, in order, in ``rec.ops`` (a list of ``OpRecord``).
    Kernel wrappers record as one op each (``kernel_call``)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._paused = 0
        self._within: Optional[str] = None

    def __enter__(self):
        recording.ACTIVE.append(self)
        try:
            return super().__enter__()
        except BaseException:
            recording.ACTIVE.remove(self)
            raise

    def __exit__(self, *exc):
        recording.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self.ops.append(OpRecord(
                f"{func._opname}.{func._overloadname}",
                _tensor_sig((args, kwargs)), _tensor_sig(out),
                kwargs.get("dtype"), _writes_input(func), self._within))
        return out

    def kernel_call(self, name, fn, args, kwargs):
        """One kernel wrapper call: its plain body on CPU tensors runs
        unrecorded; on the card its allocations record as its own."""
        first = next(t for t in pytree.tree_leaves((args, kwargs))
                     if isinstance(t, torch.Tensor))
        on_cpu = first.device.type == "cpu"
        outer = self._within
        self._paused += on_cpu
        self._within = name
        try:
            out = fn(*args, **kwargs)
        finally:
            self._paused -= on_cpu
            self._within = outer
        if not self._paused:
            self.ops.append(OpRecord(f"kernel.{name}",
                                     _tensor_sig((args, kwargs)),
                                     _tensor_sig(out), within=outer))
        return out


@dataclass(frozen=True)
class ShapeRule:
    """Forbid any recorded tensor whose shape has a dim from `dims_a` AND
    a dim from `dims_b` (the (m × S) Soft-MoE plane, the
    (B, blocks·block_size) paged row view). Padded extents ride along in
    the same sets."""

    dims_a: tuple
    dims_b: tuple
    label: str

    def flags(self, shape) -> bool:
        return (
            any(d in shape for d in self.dims_a)
            and any(d in shape for d in self.dims_b)
        )


def materialized_shapes(ops: Sequence[OpRecord],
                        rule: ShapeRule) -> List[tuple]:
    """All distinct input and output shapes of the recorded ops (a kernel
    call's and, on the card, its allocations included) flagged by
    `rule`, sorted. Empty list == the predicate is absent from the run."""
    hits = set()
    for op in ops:
        for shape in op.shapes():
            if shape and rule.flags(shape):
                hits.add(shape)
    return sorted(hits)


# ---------------------------------------------------------------------------
# Argument signatures (the retrace contract)
# ---------------------------------------------------------------------------


def arg_signature(args: tuple):
    """Hashable signature of a call's arguments: pytree structure, per
    tensor or numpy array (shape, dtype), Python scalars by type. Two
    argument tuples with equal signatures can replay one captured CUDA
    graph of the program; a signature change under churn would need a
    new capture (the reference's retrace)."""
    leaves, spec = pytree.tree_flatten(args)
    sig = []
    for leaf in leaves:
        if isinstance(leaf, (bool, int, float, complex)):
            sig.append(("py", type(leaf).__name__))
        elif isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape), str(leaf.dtype)))
        else:
            sig.append((tuple(np.shape(leaf)),
                        str(getattr(leaf, "dtype", type(leaf).__name__))))
    return (str(spec), tuple(sig))


# ---------------------------------------------------------------------------
# Program inventory
# ---------------------------------------------------------------------------


def _copy_args(args):
    """A copy of every tensor and array of `args`, structure kept."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone().requires_grad_(x.requires_grad)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    return pytree.tree_map(one, args)


@dataclass
class InPlaceRecord:
    """What one run did to a donated argument's tensor leaves: the number
    of leaves, those now bound to other storage, how many the program
    wrote in place (``_version`` moved) and how many it handed back as
    (part of) its result, storage and all."""

    n_leaves: int
    rebound: List[str]
    written: int
    returned: int


@dataclass
class Recording:
    ops: List[OpRecord]
    in_place: Dict[int, InPlaceRecord]


def _leaf_states(tree):
    out = []
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            out.append((pytree.keystr(path), leaf,
                        leaf.untyped_storage().data_ptr(), leaf._version))
    return out


def record_program(fn: Callable, args: tuple, donate: tuple = ()
                   ) -> Recording:
    """Run ``fn`` once on a copy of ``args`` under ``OpRecorder``; for
    each argnum of ``donate`` note which tensor leaves kept their storage
    and were written in place."""
    args = _copy_args(args)
    before = {i: _leaf_states(args[i]) for i in donate}
    with OpRecorder() as rec:
        out = fn(*args)
    out_ptrs = {t.untyped_storage().data_ptr()
                for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)}
    in_place = {}
    for i in donate:
        after = {p: (t, ptr) for p, t, ptr, _ in _leaf_states(args[i])}
        rebound, written, returned = [], 0, 0
        for path, t, ptr, version in before[i]:
            now = after.get(path)
            if now is None or now[0].untyped_storage().data_ptr() != ptr:
                rebound.append(path)
                continue
            written += t._version != version
            returned += ptr in out_ptrs
        in_place[i] = InPlaceRecord(len(before[i]), rebound, written,
                                    returned)
    return Recording(rec.ops, in_place)


@dataclass
class ProgramSpec:
    """One serving or training program + the contracts the passes check
    it against.

    ``fn`` must be the REAL callable the serving or training stack runs
    (harvested off a constructed backend, engine or trainer). ``args`` is
    one full example argument tuple; ``churn`` holds alternative tuples
    that model request churn (slots, tables, positions, padding) and must
    all have the same signature. ``donate`` lists argnums the program
    must update in place (the pools; the reference's donated argnums).
    ``forbid`` lists ShapeRules no recorded op may match. ``acc_dtype`` +
    ``dtype_policy`` configure the accumulation-dtype pass: "strict",
    "dots_only" or "skip", as in the reference.
    """

    name: str
    arch: str
    fn: Callable
    args: tuple
    churn: tuple = ()
    donate: tuple = ()
    forbid: tuple = ()
    acc_dtype: str = "float32"
    dtype_policy: str = "strict"
    notes: str = ""
    _recording: Optional[Recording] = field(default=None, repr=False)

    @property
    def label(self) -> str:
        return f"{self.name}@{self.arch}"

    def recording(self) -> Recording:
        """The program's one recorded run, cached across passes."""
        if self._recording is None:
            self._recording = record_program(self.fn, self.args,
                                             tuple(self.donate))
        return self._recording

    def ops(self) -> List[OpRecord]:
        return self.recording().ops


# ---------------------------------------------------------------------------
# Findings, allowlist, report
# ---------------------------------------------------------------------------


@dataclass
class Finding:
    """One contract violation. ``where`` is a program label
    ("paged/decode@qwen2-0.5b") or a source location
    ("src/repro_torch/serve/x.py:12"); allowlisted findings keep the
    reason."""

    pass_name: str
    where: str
    message: str
    allowed: bool = False
    reason: str = ""

    def render(self) -> str:
        mark = "ALLOWED" if self.allowed else "FAIL"
        line = f"[{mark}] {self.pass_name}: {self.where}: {self.message}"
        if self.allowed and self.reason:
            line += f"\n          reason: {self.reason}"
        return line


@dataclass(frozen=True)
class AllowRule:
    """Intentional exception: findings of `pass_name` whose ``where``
    fnmatch-es `pattern` are recorded (not failures). Every rule MUST
    carry a reason: that reason is the documentation of the exception."""

    pass_name: str
    pattern: str
    reason: str

    def matches(self, f: Finding) -> bool:
        return (
            f.pass_name == self.pass_name
            and fnmatch.fnmatch(f.where, self.pattern)
        )


def apply_allowlist(findings: Iterable[Finding],
                    allowlist: Sequence[AllowRule]) -> List[Finding]:
    out = []
    for f in findings:
        for rule in allowlist:
            if rule.matches(f):
                f.allowed, f.reason = True, rule.reason
                break
        out.append(f)
    return out


@dataclass
class AnalysisReport:
    findings: List[Finding] = field(default_factory=list)
    checked: Dict[str, int] = field(default_factory=dict)

    @property
    def failures(self) -> List[Finding]:
        return [f for f in self.findings if not f.allowed]

    @property
    def allowed(self) -> List[Finding]:
        return [f for f in self.findings if f.allowed]

    def ok(self) -> bool:
        return not self.failures

    def merge(self, other: "AnalysisReport"):
        self.findings.extend(other.findings)
        for k, v in other.checked.items():
            self.checked[k] = self.checked.get(k, 0) + v

    def render(self) -> str:
        lines = []
        for name in sorted(self.checked):
            n_fail = sum(1 for f in self.failures if f.pass_name == name)
            n_allow = sum(1 for f in self.allowed if f.pass_name == name)
            status = "ok" if n_fail == 0 else f"{n_fail} FAILURES"
            extra = f", {n_allow} allowlisted" if n_allow else ""
            lines.append(
                f"{name}: {self.checked[name]} checked, {status}{extra}"
            )
        for f in self.findings:
            lines.append(f.render())
        verdict = "PASS" if self.ok() else "FAIL"
        lines.append(f"analysis: {verdict}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Pass registry
# ---------------------------------------------------------------------------

PASSES: Dict[str, Callable] = {}


def register_pass(name: str):
    """Register ``fn(specs) -> (findings, n_checked)`` under `name`; the
    CLI, the pytest API and ``--passes`` pick it up from this dict."""

    def deco(fn):
        PASSES[name] = fn
        return fn

    return deco


def run_passes(specs: Sequence[ProgramSpec],
               pass_names: Optional[Sequence[str]] = None,
               allowlist: Sequence[AllowRule] = ()) -> AnalysisReport:
    """Run the named passes (default: all registered) over `specs` and
    fold the allowlist in. The pytest-facing entry point."""
    report = AnalysisReport()
    for name in pass_names or sorted(PASSES):
        if name not in PASSES:
            raise KeyError(
                f"unknown pass {name!r}; registered: {sorted(PASSES)}"
            )
        findings, n = PASSES[name](specs)
        report.findings.extend(apply_allowlist(findings, allowlist))
        report.checked[name] = report.checked.get(name, 0) + n
    return report
