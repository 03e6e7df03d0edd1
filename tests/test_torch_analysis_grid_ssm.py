"""Verdict parity of the port's contract linter with the reference's on
``mamba2-370m``: an attention-free arch, with ``paged/clear_ssm`` and no
speculative programs, whose chunk scan forms float64 decays. Every
(program@arch, pass), its train step included, has the reference's
verdict but for the known differences of ROADMAP queue 3
(``test_torch_analysis_grid.py`` holds ``qwen2-0.5b`` and the kernel
program)."""
from test_torch_analysis_grid import known, parity_grids

ARCHS = ("mamba2-370m",)


def test_verdicts_equal_the_reference_but_the_known_differences():
    port, ref = parity_grids(ARCHS, with_kernel=False)
    assert set(port) == set(ref), sorted(set(port) ^ set(ref))
    differ = {k: (ref[k], port[k]) for k in ref if ref[k] != port[k]}
    assert differ == known(ARCHS)
    assert "FAIL" not in port.values()
    assert port[("paged/clear_ssm@mamba2-370m", "donation")] == "ok"
    # the pool programs with nothing to write on an attention-free arch
    # hand their cache back as it is: in place, as donation aliases it
    for prog in ("paged/invalidate", "paged/clear_blocks",
                 "paged/copy_blocks", "contiguous/invalidate"):
        assert port[(f"{prog}@mamba2-370m", "donation")] == "ok"
    assert not any(k[0].startswith("engine/spec") for k in port)
    assert port[("train/step@mamba2-370m", "donation")] == ref[
        ("train/step@mamba2-370m", "donation")] == "ok"
