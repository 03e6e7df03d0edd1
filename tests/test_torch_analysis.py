"""The port's contract linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``), fixture by fixture: the cases of
``tests/test_analysis.py`` (but the bench wrapper's, which reads the
benchmark folder), each run through the port's pass on a torch fixture
and through the reference's pass on its JAX twin; both must give the
same findings (count, pass, kind of message). Also: ``arg_signature``,
the allowlist, the unknown-pass error, and the kernel wrappers' CPU
branches recording as one op (bitwise neutral)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import ProgramSpec as RefSpec
from repro.analysis import ShapeRule as RefRule
from repro.analysis import passes as ref_passes
from repro_torch.analysis import (
    DEFAULT_ALLOWLIST,
    AllowRule,
    Finding,
    OpRecorder,
    ProgramSpec,
    ShapeRule,
    apply_allowlist,
    arg_signature,
    host_purity_findings,
    run_passes,
)
from repro_torch.analysis.passes import (
    donation_pass,
    dtype_pass,
    materialization_pass,
    retrace_pass,
)


def _same(port, ref, port_kind, ref_kind=None):
    """Both linters found the same: count, pass, message kind."""
    (pf, pn), (rf, rn) = port, ref
    assert pn == rn
    assert len(pf) == len(rf), ([f.render() for f in pf],
                                [f.render() for f in rf])
    assert [f.pass_name for f in pf] == [f.pass_name for f in rf]
    assert all(port_kind in f.message for f in pf), [f.message for f in pf]
    assert all((ref_kind or port_kind) in f.message for f in rf)


# ---------------------------------------------------------------------------
# materialization
# ---------------------------------------------------------------------------

_M, _D, _N, _B = 48, 32, 8, 2  # pairwise-distinct marker dims


def _moe_grad_spec(use_kernel: bool) -> ProgramSpec:
    from repro_torch.analysis import kernel_program_specs

    spec = kernel_program_specs(device="cpu", b=_B, m=_M, d=_D, n=_N,
                                d_ff=24, use_kernel=use_kernel)[0]
    rule = spec.forbid[0]
    spec.forbid = (ShapeRule(rule.dims_a, rule.dims_b, "(m × s) plane"),)
    return spec


def _ref_moe_grad_spec(use_kernel: bool):
    from repro.configs.base import MoEConfig
    from repro.core import moe_apply, moe_init
    from repro.kernels.tuning import config_from_moe

    cfg = MoEConfig(variant="soft", num_experts=_N, expert_d_ff=24)
    s = _N * cfg.slots_per_expert
    params = moe_init(jax.random.PRNGKey(0), _D, cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (_B, _M, _D))
    kc = config_from_moe(cfg, m=_M, d=_D)
    m_pad = -(-_M // kc.block_tokens) * kc.block_tokens
    s_pad = -(-s // kc.block_slots) * kc.block_slots

    def loss(p):
        return (moe_apply(p, cfg, x, use_kernel=use_kernel)[0] ** 2).mean()

    return RefSpec("fixture/moe_grad", "test", jax.grad(loss), (params,),
                   forbid=(RefRule((_M, m_pad), (s, s_pad),
                                   "(m × s) plane"),))


def test_materialization_flags_ref_path():
    # the einsum path forms the (m × s) weights, the construct the
    # kernels exist to eliminate
    port = materialization_pass([_moe_grad_spec(use_kernel=False)])
    ref = ref_passes.materialization_pass([_ref_moe_grad_spec(False)])
    assert port[1] == 1 and port[0]
    _same(port, ref, "(m × s) plane")


def test_materialization_clean_on_kernel_path():
    # the reference geometry (m=320, S=48): the kernel path, forward and
    # backward, forms no plane; the wrappers record as one op each
    from repro.analysis import kernel_program_specs as ref_specs
    from repro_torch.analysis import kernel_program_specs

    spec = kernel_program_specs(device="cpu")[0]
    port = materialization_pass([spec])
    ref = ref_passes.materialization_pass(
        [s for s in ref_specs() if s.name == "kernels/soft_moe_grad"])
    assert port == (ref[0], 1) == ([], 1)
    kernels = [op.name for op in spec.ops() if op.name.startswith("kernel.")]
    assert kernels == ["kernel.routing_fwd", "kernel.combine_apply",
                       "kernel.combine_bwd", "kernel.dispatch_bwd"]


def test_materialization_skips_specs_without_rules():
    spec = ProgramSpec("fixture/norule", "test", lambda x: x + 1,
                       (torch.zeros(3),))
    ref = RefSpec("fixture/norule", "test", lambda x: x + 1,
                  (jnp.zeros(3),))
    port = materialization_pass([spec])
    assert port == ([], 0) == ref_passes.materialization_pass([ref])


# ---------------------------------------------------------------------------
# retrace
# ---------------------------------------------------------------------------


def _pad_to_multiple(ids, mult):
    n = -(-len(ids) // mult) * mult
    out = np.zeros((n,), np.int32)
    out[: len(ids)] = ids
    return out


def test_retrace_flags_shape_dependent_program():
    # a "pad to the next multiple" helper whose width follows the id
    # count: the churn-dependent shape fixed-width batching avoids
    a, b = _pad_to_multiple(np.arange(3), 4), _pad_to_multiple(
        np.arange(11), 4)
    port = retrace_pass([ProgramSpec(
        "fixture/bad_pad", "test", lambda ids: ids * 2,
        (torch.as_tensor(a),), churn=((torch.as_tensor(b),),))])
    ref = ref_passes.retrace_pass([RefSpec(
        "fixture/bad_pad", "test", lambda ids: ids * 2,
        (jnp.asarray(a),), churn=((jnp.asarray(b),),))])
    assert port[1] == 1 and port[0]
    _same(port, ref, "recompile")


def test_retrace_clean_on_fixed_shapes():
    port = retrace_pass([ProgramSpec(
        "fixture/good_pad", "test", lambda ids: ids * 2,
        (torch.zeros(8, dtype=torch.int32),),
        churn=((torch.ones(8, dtype=torch.int32),),))])
    ref = ref_passes.retrace_pass([RefSpec(
        "fixture/good_pad", "test", lambda ids: ids * 2,
        (jnp.zeros((8,), jnp.int32),),
        churn=((jnp.ones((8,), jnp.int32),),))])
    assert port == ([], 1) == ref


def test_arg_signature_distinguishes_weak_scalars():
    # a Python scalar by type, a tensor by (shape, dtype), an array too
    assert arg_signature((1.0,)) != arg_signature((torch.tensor(1.0),))
    assert arg_signature((1.0,)) == arg_signature((2.5,))
    assert arg_signature((1,)) != arg_signature((1.0,))
    assert (arg_signature((np.zeros(3, np.int32),))
            != arg_signature((np.zeros(3, np.int64),)))
    assert (arg_signature(({"k": torch.zeros(2)}, [torch.zeros(2)]),)
            != arg_signature(({"k": torch.zeros(2)}, [torch.zeros(3)]),))
    assert arg_signature(([1, 2],)) != arg_signature(([1],))


# ---------------------------------------------------------------------------
# donation (the eager meaning: updated in place)
# ---------------------------------------------------------------------------


def _pool_like():
    return [{"attn": {"k": torch.zeros(2, 4), "pos": torch.zeros(2, 4)}}]


def _ref_pool_like():
    return [{"attn": {"k": jnp.zeros((2, 4)), "pos": jnp.zeros((2, 4))}}]


def _ref_scrub(cache, slot):
    return jax.tree_util.tree_map(lambda a: a * 0, cache)


def test_donation_flags_non_donating_pool_program():
    # a program that returns a scrubbed COPY of the pool and leaves the
    # pool as it was holds two pools
    def scrub_copy(cache, slot):
        return [{k: {n: t * 0 for n, t in v.items()} for k, v in l.items()}
                for l in cache]

    port = donation_pass([ProgramSpec(
        "fixture/undonated", "test", scrub_copy, (_pool_like(), 0),
        donate=(0,))])
    ref = ref_passes.donation_pass([RefSpec(
        "fixture/undonated", "test", jax.jit(_ref_scrub),
        (_ref_pool_like(), jnp.int32(0)), donate=(0,))])
    assert port[1] == 1
    _same(port, ref, "not donated")


def test_donation_clean_when_donated():
    def scrub(cache, slot):
        for layer in cache:
            for v in layer.values():
                for t in v.values():
                    t.mul_(0)
        return cache

    spec = ProgramSpec("fixture/donated", "test", scrub, (_pool_like(), 0),
                       donate=(0,))
    port = donation_pass([spec])
    ref = ref_passes.donation_pass([RefSpec(
        "fixture/donated", "test",
        jax.jit(_ref_scrub, donate_argnums=(0,)),
        (_ref_pool_like(), jnp.int32(0)), donate=(0,))])
    assert port == ([], 1) == ref
    # the run used copies: the example arguments stay as they were
    assert spec.args[0][0]["attn"]["k"]._version == 0


def test_donation_flags_unjitted_program():
    # the reference flags a program that cannot donate (not jitted); the
    # port's twin is a program that rebinds a pool leaf to new storage
    def rebind(cache, slot):
        cache[0]["attn"]["k"] = torch.zeros(2, 4)
        return cache

    port = donation_pass([ProgramSpec(
        "fixture/rebound", "test", rebind, (_pool_like(), 0),
        donate=(0,))])
    ref = ref_passes.donation_pass([RefSpec(
        "fixture/plain", "test", _ref_scrub,
        (_ref_pool_like(), jnp.int32(0)), donate=(0,))])
    assert port[0] and "rebound" in port[0][0].message
    assert "['attn']['k']" in port[0][0].message
    _same((port[0], 0), (ref[0], 0), "not donated", "not jitted")


# ---------------------------------------------------------------------------
# dtype
# ---------------------------------------------------------------------------


def test_dtype_flags_bf16_accumulation_downcast():
    # torch.sum over bf16 emits bf16 (jnp.sum would upcast; the
    # reference's fixture reaches for lax.reduce)
    port = dtype_pass([ProgramSpec(
        "fixture/bf16_sum", "test", lambda x: x.to(torch.bfloat16).sum(0),
        (torch.zeros(4, 3),), acc_dtype="float32")])
    ref = ref_passes.dtype_pass([RefSpec(
        "fixture/bf16_sum", "test",
        lambda x: jax.lax.reduce(x.astype(jnp.bfloat16), jnp.bfloat16(0),
                                 jax.lax.add, (0,)),
        (jnp.zeros((4, 3)),), acc_dtype="float32")])
    assert port[1] == 1
    _same(port, ref, "downcast")


def test_dtype_flags_silent_f32_upcast():
    # declared bf16 accumulation, actual f32 reductions
    port = dtype_pass([ProgramSpec(
        "fixture/f32_sum", "test", lambda x: x.sum(0),
        (torch.zeros(4, 3),), acc_dtype="bfloat16")])
    ref = ref_passes.dtype_pass([RefSpec(
        "fixture/f32_sum", "test", lambda x: jnp.sum(x, axis=0),
        (jnp.zeros((4, 3), jnp.float32),), acc_dtype="bfloat16")])
    assert port[1] == 1
    _same(port, ref, "upcast")


def test_dtype_clean_on_declared_acc():
    port = dtype_pass([ProgramSpec(
        "fixture/f32_acc", "test",
        lambda x: x.sum(0, dtype=torch.float32).to(torch.bfloat16),
        (torch.zeros(4, 3, dtype=torch.bfloat16),), acc_dtype="float32")])
    ref = ref_passes.dtype_pass([RefSpec(
        "fixture/f32_acc", "test",
        lambda x: jnp.sum(x.astype(jnp.float32), axis=0).astype(
            jnp.bfloat16),
        (jnp.zeros((4, 3), jnp.bfloat16),), acc_dtype="float32")])
    assert port == ([], 1) == ref


def test_dtype_dots_only_policy_skips_reductions():
    port = dtype_pass([ProgramSpec(
        "fixture/bwd", "test", lambda x: x.to(torch.bfloat16).sum(0),
        (torch.zeros(4, 3),), acc_dtype="float32",
        dtype_policy="dots_only")])
    ref = ref_passes.dtype_pass([RefSpec(
        "fixture/bwd", "test",
        lambda x: jnp.sum(x.astype(jnp.bfloat16), axis=0),
        (jnp.zeros((4, 3)),), acc_dtype="float32",
        dtype_policy="dots_only")])
    assert port == ([], 1) == ref


# ---------------------------------------------------------------------------
# host-purity
# ---------------------------------------------------------------------------

_BAD_TICK = '''\
import torch

COMPILED = torch.compile(lambda x: x + 1)    # import-scope compile
ON_GPU = torch.cuda.is_available()           # import-time device probe


@torch.compile
def decorated(x):                            # import-scope compile, decorator
    return x


class Engine:
    def tick(self):
        v = self.logits.item()               # host sync in the tick loop
        torch.cuda.synchronize()             # host sync
        self.done_event.synchronize()        # host sync
'''

_REF_BAD_TICK = '''\
import jax

JITTED = jax.jit(lambda x: x + 1)
INTERPRET = jax.default_backend() != "tpu"


@jax.jit
def decorated(x):
    return x


class Engine:
    def tick(self):
        v = self.logits.item()
        jax.device_get(self.state)
        self.out.block_until_ready()
'''


def test_host_purity_flags_syncing_tick_loop(tmp_path):
    p, r = tmp_path / "bad_engine.py", tmp_path / "ref_bad_engine.py"
    p.write_text(_BAD_TICK)
    r.write_text(_REF_BAD_TICK)
    port = host_purity_findings([str(p)])
    ref = ref_passes.host_purity_findings([str(r)])
    msgs = "\n".join(f.message for f in port)
    assert sum("host sync" in f.message for f in port) == 3
    assert "torch.compile at import scope" in msgs
    assert "decorator" in msgs
    assert "freezes the backend choice" in msgs
    assert len(port) == len(ref) == 6
    assert ([f.where.split(":")[1] for f in port]
            == [f.where.split(":")[1] for f in ref])


def test_host_purity_clean_file(tmp_path):
    p = tmp_path / "good_engine.py"
    p.write_text(
        "import torch\n\n\n"
        "def build(cfg):\n"
        "    on_gpu = torch.cuda.is_available()\n"
        "    return torch.compile(lambda x: x + 1), on_gpu\n"
    )
    r = tmp_path / "ref_good_engine.py"
    r.write_text(
        "import jax\n\n\n"
        "def build(cfg):\n"
        "    interpret = jax.default_backend() != 'tpu'\n"
        "    return jax.jit(lambda x: x + 1), interpret\n"
    )
    assert host_purity_findings([str(p)]) == []
    assert ref_passes.host_purity_findings([str(r)]) == []


def test_host_purity_repo_clean_modulo_allowlist():
    report = run_passes([], ["host-purity"], DEFAULT_ALLOWLIST)
    assert report.ok(), report.render()
    assert report.checked["host-purity"] >= 20
    # the port's telemetry drain copies to the host with .cpu(), the
    # counterpart of the reference's np.asarray token fetch, which no
    # rule flags; the one flagged file is the autotune harness, whose
    # syncs around a timed candidate the allowlist admits, as the
    # reference's tuning.py:157,160
    assert report.findings
    assert all(f.where.startswith("src/repro_torch/kernels/tuning.py:")
               and f.allowed for f in report.findings), report.render()
    assert {r.pattern for r in DEFAULT_ALLOWLIST
            if r.pass_name == "host-purity"} == {
        "src/repro_torch/kernels/tuning.py:*",
        "src/repro_torch/serve/telemetry.py:*"}


# ---------------------------------------------------------------------------
# allowlist mechanics
# ---------------------------------------------------------------------------


def test_allowlist_matches_and_keeps_reason():
    from repro.analysis import AllowRule as RefAllow
    from repro.analysis import Finding as RefFinding
    from repro.analysis import apply_allowlist as ref_apply

    for F, A, apply in ((Finding, AllowRule, apply_allowlist),
                        (RefFinding, RefAllow, ref_apply)):
        f = F("donation", "engine/sample@qwen2-0.5b", "not donated")
        out = apply([f], [A("donation", "engine/sample@*", "by design")])
        assert out[0].allowed and out[0].reason == "by design"
        g = F("dtype", "engine/sample@qwen2-0.5b", "x")
        assert not apply([g], [A("donation", "engine/sample@*", "r")]
                         )[0].allowed


def test_unknown_pass_rejected():
    from repro.analysis import run_passes as ref_run

    with pytest.raises(KeyError):
        run_passes([], ["nonesuch"])
    with pytest.raises(KeyError):
        ref_run([], ["nonesuch"])


# ---------------------------------------------------------------------------
# the real stack: one small arch end to end
# ---------------------------------------------------------------------------


def test_serving_stack_passes_on_small_arch():
    from repro_torch.analysis import build_program_specs

    specs = build_program_specs("qwen2-0.5b", train=False, device="cpu")
    report = run_passes(
        specs, ["materialization", "retrace", "donation", "dtype"],
        DEFAULT_ALLOWLIST,
    )
    assert report.ok(), report.render()
    # the inventory is the real thing: paged decode + donation checked
    assert report.checked["donation"] >= 10
    assert any(s.name == "paged/decode" and s.forbid for s in specs)
    # K7 ran as one op per attention layer of the paged decode
    decode = next(s for s in specs if s.name == "paged/decode")
    from repro_torch.configs import get_config, reduced

    k7 = [op for op in decode.ops()
          if op.name == "kernel.paged_decode_attend"]
    assert len(k7) == reduced(get_config("qwen2-0.5b")).num_layers


def test_trainer_step_donates_state():
    from repro_torch.analysis import train_program_spec

    spec = train_program_spec("qwen2-0.5b", device="cpu")[0]
    findings, n = donation_pass([spec])
    assert n == 1 and findings == [], findings
    rec = spec.recording().in_place[0]
    # every leaf kept its storage, every param and moment and the step
    # counter were written in place
    assert rec.rebound == [] and rec.written == rec.n_leaves


# ---------------------------------------------------------------------------
# kernel opacity: a wrapper's CPU branch records as one op
# ---------------------------------------------------------------------------


def test_kernel_wrappers_record_as_one_op():
    from repro_torch.kernels import soft_moe_kernels as sk
    from repro_torch.kernels.paged_attention import paged_decode_attend

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 16, generator=gen)
    phi = torch.randn(16, 12, generator=gen)
    phi = phi / phi.norm(dim=0)
    want = sk.routing_fwd(x, phi)
    launches = sk.routing_fwd.launches
    with OpRecorder() as rec:
        got = sk.routing_fwd(x, phi)
    assert [op.name for op in rec.ops] == ["kernel.routing_fwd"]
    op = rec.ops[0]
    assert op.inputs == (((2, 40, 16), torch.float32),
                         ((16, 12), torch.float32))
    assert [s for s, _ in op.outputs] == [(2, 12, 16), (2, 12), (2, 12),
                                          (2, 40), (2, 40)]
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)  # bitwise neutral
    assert sk.routing_fwd.launches == launches  # a plain run is no launch

    # K7: the plain version gathers (B, keys, G, D); the record does not
    b, nb, bs, g, dh = 3, 4, 8, 2, 16
    q = torch.randn(b, 4, dh, generator=gen)
    kp = torch.randn(9, bs, g, dh, generator=gen)
    vp = torch.randn(9, bs, g, dh, generator=gen)
    pos = torch.arange(9 * bs, dtype=torch.int32).reshape(9, bs) % 32
    tables = torch.arange(1, 1 + b * nb, dtype=torch.int32).reshape(
        b, nb) % 9
    qpos = torch.tensor([5, 20, 31], dtype=torch.int32)
    want = paged_decode_attend(q, kp, vp, pos, tables, qpos)
    with OpRecorder() as rec:
        got = paged_decode_attend(q, kp, vp, pos, tables, qpos)
    assert [op.name for op in rec.ops] == ["kernel.paged_decode_attend"]
    assert torch.equal(got, want)
    assert all(nb * bs not in s for s in rec.ops[0].shapes())
