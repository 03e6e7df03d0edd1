"""Contract linter of the port: the serving and training stack's
invariants checked on one recorded eager run of each program,
counterpart of ``repro/analysis`` (``docs/static_analysis_torch.md``).

Five registered passes over every serving/training program:

* ``materialization`` — no (m × S) Soft-MoE plane, no
  (B, blocks·block_size) paged row view (ShapeRule predicates over the
  recorded ops; a kernel call is one op);
* ``retrace``         — churn never changes a program's argument
  signature (the precondition of one CUDA-graph capture);
* ``donation``        — pool-carrying programs update their cache in
  place (storage kept, ``_version`` moved);
* ``dtype``           — accumulations agree with the declared
  ``KernelConfig.acc_dtype``;
* ``host-purity``     — AST lint: no host syncs in the tick path, no
  import-scope compile, no import-time device probes.

CLI: ``python -m repro_torch.analysis --all [--device cpu]``. Pytest
API: build specs with ``build_program_specs(arch, device="cpu")`` (or
hand-rolled ``ProgramSpec`` fixtures) and run ``run_passes(specs, [...],
DEFAULT_ALLOWLIST)``.
"""
from .framework import (  # noqa: F401
    AllowRule,
    AnalysisReport,
    Finding,
    OpRecord,
    OpRecorder,
    PASSES,
    ProgramSpec,
    ShapeRule,
    apply_allowlist,
    arg_signature,
    materialized_shapes,
    register_pass,
    run_passes,
)
from .passes import (  # noqa: F401
    donation_pass,
    dtype_pass,
    host_purity_findings,
    host_purity_pass,
    materialization_pass,
    retrace_pass,
    serve_side_sources,
)
from .programs import (  # noqa: F401
    DEFAULT_ALLOWLIST,
    GRID,
    build_program_specs,
    grid_specs,
    kernel_program_specs,
    serving_program_specs,
    train_program_spec,
)
