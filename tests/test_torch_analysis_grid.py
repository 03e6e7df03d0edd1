"""Verdict parity of the port's contract linter with the reference's: for
every (program@arch, pass) of ``qwen2-0.5b``, its train step and the
Soft-MoE kernel program, the port's verdict (ok, FAIL, ALLOWED) equals
``repro.analysis.run_passes``' on the same grid, but for the known
differences ROADMAP queue 3 lists, each with its own ``AllowRule``
(``mamba2-370m``, which has ``clear_ssm`` and no speculative programs,
is held the same way in ``test_torch_analysis_grid_ssm.py``). Also the
falsifiable halves on the real stack: the paged gather path is flagged
for the row view, the kernel program's einsum twin for the (m × S)
plane, and the host-purity scan of the port."""
import pytest

from repro_torch.analysis import (
    DEFAULT_ALLOWLIST,
    build_program_specs,
    kernel_program_specs,
    run_passes,
)

ARCHS = ("qwen2-0.5b",)
PROGRAM_PASSES = ("materialization", "retrace", "donation", "dtype")

# (label, pass) -> (the reference's verdict, the port's): ROADMAP queue 3
KNOWN = {
    # the port clears a host list of block ids whose length follows the
    # request; the reference pads them to a fixed width (_pad_ids)
    **{(f"paged/clear_blocks@{a}", "retrace"): ("ok", "ALLOWED")
       for a in ("qwen2-0.5b", "mamba2-370m")},
    # the SSD chunk scan forms its decays by a float64 cumulative sum
    **{(f"{b}/{p}@mamba2-370m", "dtype"): ("ok", "ALLOWED")
       for b in ("contiguous", "paged") for p in ("prefill_chunk",
                                                  "verify")},
}


def known(archs):
    """The known differences on the grid of ``archs``."""
    return {k: v for k, v in KNOWN.items()
            if k[0].split("@")[1] in archs}


def _verdicts(specs, report):
    """{(label, pass): "ok" | "FAIL" | "ALLOWED"} for every pass each spec
    was checked by (the same rule in both packages' passes)."""
    out = {}
    for s in specs:
        checked = {"materialization": bool(s.forbid),
                   "retrace": bool(s.churn), "donation": bool(s.donate),
                   "dtype": s.dtype_policy != "skip"}
        for name, on in checked.items():
            if on:
                out[(s.label, name)] = "ok"
    for f in report.findings:
        key = (f.where, f.pass_name)
        if f.allowed:
            out[key] = "ALLOWED" if out.get(key) != "FAIL" else "FAIL"
        else:
            out[key] = "FAIL"
    return out


def parity_grids(archs, with_kernel):
    """The port's and the reference's verdicts on ``archs`` (serving
    programs and train step) and, with ``with_kernel``, the Soft-MoE
    kernel program."""
    from repro.analysis import DEFAULT_ALLOWLIST as REF_ALLOW
    from repro.analysis import build_program_specs as ref_build
    from repro.analysis import kernel_program_specs as ref_kernel
    from repro.analysis import run_passes as ref_run

    port, ref = {}, {}
    for arch in archs:
        specs = build_program_specs(arch, device="cpu")
        port.update(_verdicts(specs, run_passes(specs, PROGRAM_PASSES,
                                                DEFAULT_ALLOWLIST)))
        specs = ref_build(arch)
        ref.update(_verdicts(specs, ref_run(specs, PROGRAM_PASSES,
                                            REF_ALLOW)))
    if with_kernel:
        specs = kernel_program_specs(device="cpu")
        port.update(_verdicts(specs, run_passes(specs, PROGRAM_PASSES,
                                                DEFAULT_ALLOWLIST)))
        specs = ref_kernel()
        ref.update(_verdicts(specs, ref_run(specs, PROGRAM_PASSES,
                                            REF_ALLOW)))
    return port, ref


@pytest.fixture(scope="module")
def grids():
    return parity_grids(ARCHS, with_kernel=True)


def test_verdicts_equal_the_reference_but_the_known_differences(grids):
    port, ref = grids
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))
    differ = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert differ == known(ARCHS)
    assert "FAIL" not in port.values()
    assert ("kernels/soft_moe_grad@soft-moe", "materialization") in port
    assert ("engine/spec_accept@qwen2-0.5b", "retrace") in port


def test_train_step_updates_its_state_in_place(grids):
    port, ref = grids
    key = ("train/step@qwen2-0.5b", "donation")
    assert port[key] == ref[key] == "ok"


def test_paged_gather_path_is_flagged():
    """With K7 off (``use_kernel=False``) paged decode gathers each row's
    (B, blocks·block_size) view, and the linter says so; with K7 on the
    same program is clean."""
    from repro_torch.analysis import serving_program_specs
    from repro_torch.analysis.passes import materialization_pass

    def decode(use_kernel):
        specs = serving_program_specs("qwen2-0.5b", device="cpu",
                                      use_kernel=use_kernel)
        return next(s for s in specs if s.name == "paged/decode")

    findings, n = materialization_pass([decode(False)])
    assert n == 1 and len(findings) == 1
    assert "(3 × 112) paged row-view gather" in findings[0].message
    assert materialization_pass([decode(True)]) == ([], 1)


def test_kernel_program_einsum_twin_is_flagged():
    from repro_torch.analysis.passes import materialization_pass

    spec = kernel_program_specs(device="cpu", use_kernel=False)[0]
    findings, n = materialization_pass([spec])
    assert n == 1 and len(findings) == 1
    assert "(m × S) Soft-MoE plane (m=320/320, s=48/64)" in \
        findings[0].message
    assert "(3, 320, 48, 1)" in findings[0].message


def test_shared_experts_sum_in_f32():
    """deepseek's shared experts are summed with an f32 accumulator, as
    the reference's jnp.sum does: the port's bf16 serving programs were
    flagged for a bf16 ``sum`` before."""
    from repro_torch.analysis.passes import dtype_pass

    specs = [s for s in build_program_specs(
        "deepseek-v2-lite-16b", train=False, device="cpu")
        if s.name in ("paged/decode", "contiguous/decode")]
    assert dtype_pass(specs) == ([], 2)


def test_host_purity_of_the_port_modulo_allowlist():
    from repro_torch.analysis import serve_side_sources

    report = run_passes([], ["host-purity"], DEFAULT_ALLOWLIST)
    assert report.ok(), report.render()
    paths = serve_side_sources()
    assert report.checked["host-purity"] == len(paths)
    assert any(p.endswith("serve/engine.py") for p in paths)
    assert any(p.endswith("kernels/soft_moe_kernels.py") for p in paths)
