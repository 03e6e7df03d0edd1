"""Public names of the JAX package that the port carries beside its
sampler and its tile policy:

- ``serve.stack_params`` against the reference's arrays, dtypes
  included; ``serve.sample_greedy`` against ``jnp.argmax`` (and the
  reference's ``sample_greedy``) on the same logits;
  ``serve.sample_temperature`` drawing (B,) int32 from an explicit
  ``torch.Generator`` (the same generator state gives the same draws),
  at the softmax's frequencies at T = 1, and equal to greedy as T goes to
  1e-6;
- ``kernels.tuning.autotune`` with a fake ``build_fn`` whose thunks
  advance a fake host clock by config: it picks the fastest, skips a candidate that raises
  and never tries blocks above ``SOFT_MOE_TILE``.

The JAX reference is imported by the ``jx`` fixture."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.tuning import (
    DEFAULT_SWEEP,
    SOFT_MOE_TILE,
    KernelConfig,
    autotune,
)
from repro_torch.serve import (
    SamplingParams,
    sample_greedy,
    sample_temperature,
    stack_params,
)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.serve import sampling as jsampling

    return types.SimpleNamespace(jnp=jnp, sampling=jsampling)


def test_stack_params_equals_the_reference(jx):
    sp = [SamplingParams(), SamplingParams(temperature=0.7, top_k=5,
                                           top_p=0.9, seed=3),
          SamplingParams(temperature=2.0, top_p=0.5, seed=-1)]
    ref = jx.sampling.stack_params(
        [jx.sampling.SamplingParams(**vars(p)) for p in sp])
    got = stack_params(sp)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k])


def test_sample_greedy_equals_argmax(jx):
    logits = np.random.RandomState(0).randn(5, 3, 50).astype(np.float32)
    got = sample_greedy(None, torch.from_numpy(logits))
    assert got.dtype == torch.int32 and got.shape == (5,)
    want = jx.jnp.argmax(jx.jnp.asarray(logits)[:, -1], axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx.sampling.sample_greedy(
            None, jx.jnp.asarray(logits))))


def test_sample_temperature_draws_from_the_generator():
    logits = torch.from_numpy(
        np.random.RandomState(1).randn(4, 2, 30).astype(np.float32))
    a = sample_temperature(torch.Generator().manual_seed(5), logits, 1.0)
    b = sample_temperature(torch.Generator().manual_seed(5), logits, 1.0)
    assert a.dtype == torch.int32 and a.shape == (4,)
    assert torch.equal(a, b)
    greedy = sample_greedy(None, logits)
    for t in (1e-6, 1e-9, 0.0):
        cold = sample_temperature(torch.Generator().manual_seed(9), logits,
                                  t)
        assert torch.equal(cold, greedy), t
    # frequencies at T = 1 follow the softmax of the last position
    row = torch.tensor([[[0.0, 1.0, -1.0, 0.5]]]).expand(4000, 1, 4)
    draws = sample_temperature(torch.Generator().manual_seed(2), row, 1.0)
    freq = torch.bincount(draws.long(), minlength=4).float() / 4000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(row[0, 0], -1).numpy(),
                               atol=0.03)


def test_autotune_picks_the_fastest_and_skips_failures(monkeypatch):
    # the host clock is a fake one that each thunk advances by its cost,
    # so the pick does not depend on how busy the machine is
    clock = [0.0]
    monkeypatch.setattr(tuning, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0]))
    cost = {(16, 16): 4, (16, 32): 1, (32, 16): 3, (32, 32): 2}
    built = []

    def build_fn(cfg):
        key = (cfg.block_tokens, cfg.block_slots)
        built.append(key)
        if key == (16, 32):
            raise ValueError("this tiling does not fit")

        def thunk():
            clock[0] += 0.002 * cost.get(key, 5)
            return torch.zeros(1)

        return thunk

    sweep = ((16, 16), (16, 32), (32, 16), (32, 32), (64, 64))
    best = autotune(build_fn, KernelConfig(acc_dtype="float32"), sweep,
                    iters=2)
    assert (best.block_tokens, best.block_slots) == (32, 32)
    assert (64, 64) not in built  # above SOFT_MOE_TILE: never tried
    assert all(max(c) <= SOFT_MOE_TILE for c in DEFAULT_SWEEP)
    # nothing runs: the base comes back
    base = KernelConfig(block_tokens=8)
    assert autotune(lambda cfg: 1 / 0, base, sweep, iters=1) is base
