"""The port's roofline package against the JAX package's:

- ``roofline/flops.py``: ``fwd_flops``, ``analytic_cost(...).per_device``
  and ``analysis.model_flops`` equal the JAX functions exactly on every
  ``ASSIGNED`` arch × every ``SHAPES`` entry;
- the analytic decode FLOPs against ``FlopCounterMode`` on the port's own
  decode forward (the counterpart of ``tests/test_roofline.py``'s check
  against XLA's cost analysis of the unrolled decode graph);
- ``serving_program_bounds`` keeps its import path and its numbers;
- ``Collective.alg_factor`` and the ``ModuleCollectives`` sums equal the
  reference's ``hlo_parse`` classes on the same collectives.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax.
"""
import types

import pytest
import torch

from repro_torch.configs import ASSIGNED_NAMES, SHAPES, get_config, reduced
from repro_torch.roofline.analysis import model_flops
from repro_torch.roofline.collectives import Collective, ModuleCollectives
from repro_torch.roofline.flops import analytic_cost, fwd_flops

CELLS = [(a, s) for a in ASSIGNED_NAMES for s in SHAPES]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.configs import get_config as jget_config
    from repro.roofline import analysis, flops, hlo_parse

    return types.SimpleNamespace(get_config=jget_config, flops=flops,
                                 analysis=analysis, hlo_parse=hlo_parse)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}:{s}" for a, s in CELLS])
def test_analytic_model_equals_jax(jx, arch, shape):
    cfg, jcfg = get_config(arch), jx.get_config(arch)
    sh = SHAPES[shape]
    b, s = sh.global_batch, sh.seq_len
    if sh.mode == "decode":
        args = (b, 1, "decode", s)
    else:
        args = (b, s, sh.mode)
    assert fwd_flops(cfg, *args) == jx.flops.fwd_flops(jcfg, *args)
    got, want = analytic_cost(cfg, shape), jx.flops.analytic_cost(jcfg, shape)
    assert got.per_device(256) == want.per_device(256)
    assert got.notes == want.notes
    assert (model_flops(cfg, sh, sh.mode)
            == jx.analysis.model_flops(jcfg, sh, sh.mode))


def test_analytic_flops_cross_check_vs_flop_counter():
    """The analytic decode FLOPs within 0.4-2.5 of what
    ``FlopCounterMode`` counts on the port's decode forward (it counts
    the matmuls; the model ignores elementwise work)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import init_cache, lm_apply, lm_init

    cfg = reduced(get_config("llama3-8b"))
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    B, S = 4, 64
    cache = init_cache(cfg, B, S, device="cpu")
    toks = torch.zeros((B, 1), dtype=torch.long)
    with FlopCounterMode(display=False) as fc:
        lm_apply(params, cfg, toks, positions=torch.arange(63, 64),
                 cache=cache, mode="decode")
    counted = fc.get_total_flops()
    ana = fwd_flops(cfg, B, 1, "decode", cache_len=S)
    assert ana > 0 and counted > 0
    ratio = ana / counted
    assert 0.4 < ratio < 2.5, f"analytic/counted flops ratio {ratio:.2f}"


def test_serving_program_bounds_import_path():
    from repro_torch.roofline import (
        HBM_BW,
        PEAK_FLOPS_BF16,
        serving_program_bounds,
    )

    cfg = get_config("qwen2-0.5b")
    n = cfg.active_param_count()
    got = serving_program_bounds(cfg, 8, 256, verify_lanes=5)
    assert got == {
        "decode": max(2.0 * n * 8 / PEAK_FLOPS_BF16, 2 * n / HBM_BW),
        "prefill_chunk": max(2.0 * n * 256 / PEAK_FLOPS_BF16, 2 * n / HBM_BW),
        "verify": max(2.0 * n * 40 / PEAK_FLOPS_BF16, 2 * n / HBM_BW),
    }


def test_collective_sums_equal_hlo_parse(jx):
    ops = [("all-reduce", 4096, 16, False, 3), ("all-reduce", 64, 2, True, 1),
           ("all-gather", 1 << 20, 16, False, 24), ("all-gather", 512, 1,
                                                      False, 1),
           ("reduce-scatter", 8192, 16, True, 5), ("all-to-all", 300, 8,
                                                   False, 2),
           ("collective-permute", 128, 4, False, 7)]
    mine = ModuleCollectives([Collective(*o) for o in ops])
    ref = jx.hlo_parse.ModuleCollectives(
        [jx.hlo_parse.Collective(*o) for o in ops])
    for a, b in zip(mine.collectives, ref.collectives):
        assert a.alg_factor() == b.alg_factor()
    assert mine.weighted_ici_bytes() == ref.weighted_ici_bytes()
    assert mine.weighted_pod_bytes() == ref.weighted_pod_bytes()
    assert mine.by_kind() == ref.by_kind()
    assert mine.counts() == ref.counts()
