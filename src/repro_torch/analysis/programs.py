"""Program inventory: every serving and training program of the port as a
``ProgramSpec``, counterpart of ``repro/analysis/programs.py``.

The specs harvest the REAL callables off constructed backends, engines
and trainers (``be._decode``, ``eng._sample``, ``trainer.train_step``,
the pool maintenance functions the backends call, ...), never
re-declarations, so the linter checks what production runs. Each spec
carries the reference's label even where the port's attribute differs:
``contiguous/clear_slot`` is ``cache_pool.clear_slot``, the paged
``invalidate`` / ``clear_blocks`` / ``copy_blocks`` / ``clear_ssm`` are
the ``serve/programs.py`` functions ``PagedBackend`` calls, and
``engine/spec_accept`` / ``engine/spec_finite`` are the sampling
functions ``SpecDecoder`` calls. Argument tuples mirror the call sites'
conversions (``torch.as_tensor(in_toks)`` of int64 host tokens, int32
positions and tables, Python-int slots, host numpy sampling params, a
Python list of block ids); churn variants change VALUES the way request
churn does.

Geometry: ``batch=3`` rows, ``max_len=112`` (7 blocks × 16), spec lanes
``k+1=4``, as in the reference. 3 and 112 are distinct from every
``reduced()`` model axis, so the (B, blocks·block_size) ShapeRule can
only match the paged row view; ``_check_dims`` enforces it against the
actual param and cache shapes instead of assuming.
"""
from __future__ import annotations

import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..configs import ASSIGNED_NAMES, get_config, reduced
from ..layers.common import resolve_device
from ..models import build_model, lm_init
from ..optim import tree_leaves, tree_map
from .framework import AllowRule, ProgramSpec, ShapeRule

GRID = ASSIGNED_NAMES

BATCH = 3
MAX_LEN = 112
BLOCK_SIZE = 16
SPEC_K = 3  # verify lanes = k+1 = 4


# ---------------------------------------------------------------------------
# The allowlist: every intentional exception, with its reason
# ---------------------------------------------------------------------------

DEFAULT_ALLOWLIST = (
    AllowRule(
        "donation", "engine/sample@*",
        "the sampler reads the engine's persistent logits buffer "
        "non-destructively; the same buffer feeds the next prefill/"
        "decode write after sampling, so donating it would free live "
        "engine state",
    ),
    AllowRule(
        "materialization", "paged/verify@*",
        "S>1 programs take the gather path — the paged decode-attention "
        "kernel (K7) is single-query; tracked by the ROADMAP 'multi-query "
        "K7 for the verify' lever",
    ),
    AllowRule(
        "materialization", "paged/prefill_chunk@*",
        "chunked prefill (S>1) takes the gather path — same ROADMAP "
        "multi-query K7 item as verify",
    ),
    AllowRule(
        "materialization", "paged/decode@deepseek-v2-lite-16b",
        "MLA absorbed-form decode keeps the gather path (K7 covers GQA "
        "only — layers/attention.py documents it), as in the reference",
    ),
    *(AllowRule(
        "dtype", f"*/{prog}@{arch}",
        "the SSD chunk scan forms its decays by a float64 cumulative sum, "
        "rounded once to float32: the reference's float32 differences of "
        "one cumulative sum cancel at mamba2's width (ROADMAP queue 3)",
    ) for arch in ("mamba2-370m", "hymba-1.5b")
      for prog in ("prefill_chunk", "verify")),
    AllowRule(
        "retrace", "paged/clear_blocks@*",
        "the port clears the host's list of freshly allocated block ids "
        "eagerly (admission clears a prompt's blocks, decode one): the "
        "list's length follows the request; a CUDA graph of it would pad "
        "the ids to a fixed width, as the reference's _pad_ids does "
        "(ROADMAP queue 3)",
    ),
    AllowRule(
        "host-purity", "src/repro_torch/kernels/tuning.py:*",
        "a timing harness must synchronize around the candidate it times "
        "— it runs offline (bench/startup), never inside the engine tick",
    ),
    AllowRule(
        "host-purity", "src/repro_torch/serve/telemetry.py:*",
        "TelemetryAggregator.drain is the engine's one sanctioned "
        "device->host sync point — called once per tick AFTER the tokens "
        "of the tick are committed (_to_host)",
    ),
)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _check_dims(label: str, trees, rules: tuple):
    """Raise if a param or cache tensor is itself flagged by a ShapeRule:
    the dim-disjointness precondition of the shape predicates (a model
    tensor that legitimately carries BOTH marker dims would make the
    rule vacuously noisy)."""
    for tree in trees:
        for leaf in tree_leaves(tree):
            shape = tuple(leaf.shape)
            for rule in rules:
                if shape and rule.flags(shape):
                    raise ValueError(
                        f"{label}: model tensor of shape {shape} "
                        f"collides with rule {rule.label!r}; pick "
                        "different geometry"
                    )


def _row_view_rule(batch: int, view_len: int) -> ShapeRule:
    return ShapeRule(
        (batch,), (view_len,),
        f"({batch} × {view_len}) paged row-view gather",
    )


def _unwrap(fn):
    """The program under an engine's ``ProgramTimer``."""
    return getattr(fn, "fn", fn)


# ---------------------------------------------------------------------------
# serving programs
# ---------------------------------------------------------------------------


def serving_program_specs(arch: str, batch: int = BATCH,
                          max_len: int = MAX_LEN,
                          block_size: int = BLOCK_SIZE, *,
                          device="cuda", full_width: bool = False,
                          use_kernel: bool = True) -> List[ProgramSpec]:
    """Specs for every program of one arch's contiguous AND paged engines
    (+ sampler, + speculative accept where supported), on ``device``.
    ``full_width`` serves the config as published instead of
    ``reduced``; ``use_kernel`` is the paged backend's K7 switch (the
    engine's default, on)."""
    from ..serve import cache_pool
    from ..serve import programs as sprog
    from ..serve import spec_decode
    from ..serve.engine import ServeEngine
    from ..serve.spec_decode import SpecConfig

    dev = resolve_device(device)
    cfg = get_config(arch) if full_width else reduced(get_config(arch))
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg)
    spec_ok = cfg.attention is not None and cfg.ssm is None
    eng_c = ServeEngine(cfg, params, batch_size=batch, max_len=max_len,
                        backend="contiguous", device=dev)
    eng_p = ServeEngine(cfg, params, batch_size=batch, max_len=max_len,
                        backend="paged", block_size=block_size,
                        use_kernel=use_kernel,
                        spec=SpecConfig(k=SPEC_K) if spec_ok else None,
                        device=dev)
    del params
    cb, pb = eng_c.backend, eng_p.backend
    sparams = eng_c.params  # the serving cast both engines run

    view_len = pb.blocks_per_row * block_size
    _check_dims(f"{arch} serving geometry", (sparams, pb.cache),
                (_row_view_rule(batch, view_len),
                 _row_view_rule(1, view_len)))

    V = cfg.vocab_size
    lanes = SPEC_K + 1
    buf = torch.zeros((batch, V), dtype=torch.float32, device=dev)
    specs: List[ProgramSpec] = []

    def rows(vals):
        """``vals`` repeated over the batch's rows."""
        return [vals[i % len(vals)] for i in range(batch)]

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)

    # -- contiguous ---------------------------------------------------------
    chunk_c = min(32, cb.max_chunk)

    def chunk_args(slot, fill, pad=0):
        toks = [0] * pad + [fill] * (chunk_c - pad)
        poss = [-1] * pad + list(range(chunk_c - pad))
        return (slot, i64([toks]), i32([poss]))

    specs.append(ProgramSpec(
        "contiguous/prefill_chunk", arch, cb._prefill_chunk,
        (sparams, cb.pool.cache, buf) + chunk_args(0, 1),
        churn=(
            (sparams, cb.pool.cache, buf) + chunk_args(2, 7),
            (sparams, cb.pool.cache, buf) + chunk_args(1, 3, pad=5),
        ),
        donate=(1, 2),
        acc_dtype="float32",
    ))

    def decode_args(toks, pos):
        return (sparams, i64(toks), i32(pos), cb.pool.cache)

    specs.append(ProgramSpec(
        "contiguous/decode", arch, cb._decode,
        decode_args([[1]] * batch, [4] * batch),
        churn=(
            decode_args(rows([[7], [2], [9]]), rows([10, 3, 55])),
            decode_args([[0]] * batch, rows([-1, 6, -1])),  # inactive
        ),
        donate=(3,),
        acc_dtype="float32",
    ))

    def cverify_args(pos):
        return (sparams, i64(np.ones((batch, lanes))), i32(pos),
                cb.pool.cache)

    specs.append(ProgramSpec(
        "contiguous/verify", arch, cb._verify,
        cverify_args([[5, 6, 7, 8]] * batch),
        churn=(cverify_args(rows([[5, 6, -1, -1], [1, -1, -1, -1],
                                  [9, 10, 11, -1]])),),
        donate=(3,),
        acc_dtype="float32",
    ))

    specs.append(ProgramSpec(
        "contiguous/invalidate", arch, cb._invalidate,
        (cb.pool.cache, i32(np.full((batch, lanes), 6))),
        churn=((cb.pool.cache, i32(np.full((batch, lanes), -1))),),
        donate=(0,),
        dtype_policy="skip",  # pure scatter, no accumulation
    ))

    specs.append(ProgramSpec(
        "contiguous/clear_slot", arch, cache_pool.clear_slot,
        (cb.pool.cache, 0),
        churn=((cb.pool.cache, batch - 1),),
        donate=(0,),
        dtype_policy="skip",
    ))

    # -- paged --------------------------------------------------------------
    chunk_p = min(32, pb.max_chunk)
    nb = pb.blocks_per_row
    table1 = i32(np.arange(1, nb + 1)[None])
    tables = i32(np.arange(1, batch * nb + 1).reshape(batch, nb))

    def pchunk_args(slot, fill, pad=0):
        toks = [0] * pad + [fill] * (chunk_p - pad)
        poss = [-1] * pad + list(range(chunk_p - pad))
        return (sparams, pb.cache, buf, slot, table1, i64([toks]),
                i32([poss]))

    specs.append(ProgramSpec(
        "paged/prefill_chunk", arch, pb._prefill_chunk,
        pchunk_args(0, 1),
        churn=(pchunk_args(2, 7), pchunk_args(1, 3, pad=9)),
        donate=(1, 2),
        forbid=((_row_view_rule(1, view_len),)
                if cfg.attention is not None else ()),
        acc_dtype="float32",
    ))

    def pdecode_args(toks, pos):
        return (sparams, i64(toks), i32(pos), tables, pb.cache)

    specs.append(ProgramSpec(
        "paged/decode", arch, pb._decode,
        pdecode_args([[1]] * batch, [4] * batch),
        churn=(
            pdecode_args(rows([[7], [2], [9]]), rows([10, 3, 55])),
            pdecode_args([[0]] * batch, rows([-1, 6, -1])),
        ),
        donate=(4,),
        forbid=((_row_view_rule(batch, view_len),)
                if cfg.attention is not None else ()),
        acc_dtype="float32",
        notes="the no-row-view kernel proof",
    ))

    def pverify_args(pos):
        return (sparams, i64(np.ones((batch, lanes))), i32(pos), tables,
                pb.cache)

    specs.append(ProgramSpec(
        "paged/verify", arch, pb._verify,
        pverify_args([[5, 6, 7, 8]] * batch),
        churn=(pverify_args(rows([[5, -1, -1, -1], [1, 2, -1, -1],
                                  [9, 10, 11, -1]])),),
        donate=(4,),
        forbid=((_row_view_rule(batch, view_len),)
                if cfg.attention is not None else ()),
        acc_dtype="float32",
    ))

    specs.append(ProgramSpec(
        "paged/invalidate", arch, sprog.invalidate_positions_paged_program,
        (pb.cache, i32(np.full((batch, lanes), 6)), tables),
        churn=((pb.cache, i32(np.full((batch, lanes), -1)), tables),),
        donate=(0,),
        dtype_policy="skip",
    ))

    # the backend clears a prompt's fresh blocks at admission and one
    # block at a time at decode; copy-on-write copies one block
    specs.append(ProgramSpec(
        "paged/clear_blocks", arch, sprog.clear_blocks_program,
        (pb.cache, list(range(1, 9))), churn=((pb.cache, [5]),),
        donate=(0,), dtype_policy="skip",
    ))
    specs.append(ProgramSpec(
        "paged/copy_blocks", arch, sprog.copy_blocks_program,
        (pb.cache, [1], [2]), churn=((pb.cache, [7], [3]),),
        donate=(0,), dtype_policy="skip",
    ))
    if cfg.has_ssm():
        specs.append(ProgramSpec(
            "paged/clear_ssm", arch, sprog.clear_ssm_slot_program,
            (pb.cache, 0), churn=((pb.cache, batch - 1),),
            donate=(0,), dtype_policy="skip",
        ))

    # -- engine-level -------------------------------------------------------
    def sample_args(temp, step):
        return (
            buf,
            np.asarray(temp, np.float32),
            np.zeros((batch,), np.int32),
            np.ones((batch,), np.float32),
            np.zeros((batch,), np.int32),
            np.asarray(step, np.int32),
        )

    specs.append(ProgramSpec(
        "engine/sample", arch, _unwrap(eng_c._sample),
        sample_args([0.0] * batch, [0] * batch),
        churn=(sample_args(rows([0.7, 0.0, 2.0]), rows([3, 0, 9])),),
        donate=(0,),  # intentionally NOT updated -> allowlist entry
        acc_dtype="float32",
    ))

    if eng_p._spec is not None:
        k = SPEC_K

        def accept_args(n_draft, temp):
            logits = torch.zeros((batch, lanes, V), dtype=torch.float32,
                                 device=dev)
            return (logits, np.ones((batch, k), np.int64),
                    np.asarray(n_draft, np.int32),
                    np.asarray(temp, np.float32),
                    np.zeros((batch,), np.int32),
                    np.ones((batch,), np.float32),
                    np.zeros((batch,), np.int32),
                    np.zeros((batch,), np.int32))

        specs.append(ProgramSpec(
            "engine/spec_accept", arch, spec_decode.spec_accept_tokens,
            accept_args([k] * batch, [0.0] * batch),
            churn=(accept_args(rows([0, 1, k]), rows([0.5, 0.0, 1.5])),),
            acc_dtype="float32",
        ))
        specs.append(ProgramSpec(
            "engine/spec_finite", arch, spec_decode.finite_rows,
            (buf,), churn=((torch.ones_like(buf),),),
            dtype_policy="skip",  # pure isfinite reduction over bools
        ))

    return specs


# ---------------------------------------------------------------------------
# training program
# ---------------------------------------------------------------------------


def train_program_spec(arch: str, *, device="cuda") -> List[ProgramSpec]:
    """The Trainer's own train step (autograd + AdamW, in place).

    ``dtype_policy="dots_only"``: the backward reduce-sums bf16
    cotangents when it transposes broadcasts (gradient dtype follows the
    forward compute dtype), so the strict reduction rule applies to
    serving programs only; the dot-downcast rule still holds here."""
    from ..data import SyntheticLM, SyntheticSeq2Seq
    from ..optim import OptimizerConfig
    from ..train import Trainer, TrainerConfig
    from ..train.step import init_train_state

    dev = resolve_device(device)
    cfg = reduced(get_config(arch))
    init_fn, loss_fn, _ = build_model(cfg)
    if cfg.encoder_layers > 0:
        data = SyntheticSeq2Seq(
            vocab_size=cfg.vocab_size, seq_len=16,
            num_frames=cfg.frontend.num_embeds,
            frame_dim=cfg.frontend.embed_dim, batch_size=2, device=dev,
        )
    else:
        data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16,
                           batch_size=2, device=dev)
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(
            TrainerConfig(total_steps=1, checkpoint_dir=d),
            loss_fn, init_fn, OptimizerConfig(total_steps=1), data,
        )
    state = init_train_state(torch.Generator(device=dev).manual_seed(0),
                             init_fn)
    return [ProgramSpec(
        "train/step", arch, trainer.train_step,
        (state, data.batch(0)),
        churn=((state, data.batch(1)),),
        donate=(0,),
        acc_dtype="float32",
        dtype_policy="dots_only",
    )]


# ---------------------------------------------------------------------------
# Soft-MoE kernel program (the paper's (m × S) claim, fwd + bwd)
# ---------------------------------------------------------------------------


def kernel_program_specs(*, device="cuda", b: int = 3, m: int = 320,
                         d: int = 160, n: int = 48, d_ff: int = 224,
                         style: str = "gated", act: str = "silu",
                         dtype=torch.float32,
                         use_kernel: bool = True) -> List[ProgramSpec]:
    """The fused Soft-MoE train path: the gradient of a kernel-routed
    loss must carry no (m × S) plane in EITHER direction (dims pairwise
    distinct: m=320, d=160, S=48, d_ff=224, b=3, as in the reference;
    the keywords give other shapes, B/16's layer on the card). With
    ``use_kernel=False`` the spec is the einsum path, named
    ``kernels/soft_moe_grad_einsum``, which forms the plane."""
    from ..configs import MoEConfig
    from ..core import moe_apply, moe_init
    from ..kernels.tuning import config_from_moe

    dev = resolve_device(device)
    cfg = MoEConfig(variant="soft", num_experts=n, expert_d_ff=d_ff)
    s = n * cfg.slots_per_expert
    params = moe_init(torch.Generator(device=dev).manual_seed(0), d, cfg,
                      style)
    x = torch.randn((b, m, d), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(dtype)
    kc = config_from_moe(cfg, m=m, d=d)
    m_pad = -(-m // kc.block_tokens) * kc.block_tokens
    s_pad = -(-s // kc.block_slots) * kc.block_slots
    rule = ShapeRule(
        (m, m_pad), (s, s_pad),
        f"(m × S) Soft-MoE plane (m={m}/{m_pad}, s={s}/{s_pad})",
    )
    _check_dims("Soft-MoE kernel geometry", (params, {"x": x}), (rule,))

    def grad(p):
        wrt = tree_map(lambda t: t.detach().requires_grad_(), p)
        leaves = tree_leaves(wrt)
        with torch.enable_grad():
            loss = (moe_apply(wrt, cfg, x, act,
                              use_kernel=use_kernel)[0] ** 2).mean()
            grads = iter(torch.autograd.grad(loss, leaves))
        return tree_map(lambda _: next(grads), p)

    name = "kernels/soft_moe_grad" + ("" if use_kernel else "_einsum")
    return [ProgramSpec(
        name, "soft-moe", grad, (params,),
        forbid=(rule,),
        acc_dtype=kc.acc_dtype,
        dtype_policy="dots_only",  # bwd cotangent sums follow x's dtype
        notes="PAPER.md §2 linear-memory claim, fwd+bwd",
    )]


# ---------------------------------------------------------------------------
# top-level inventory
# ---------------------------------------------------------------------------


def build_program_specs(arch: str, train: bool = True, *,
                        device="cuda") -> List[ProgramSpec]:
    """Full spec list for one arch (serving + train step)."""
    specs = serving_program_specs(arch, device=device)
    if train:
        specs += train_program_spec(arch, device=device)
    return specs


def grid_specs(archs: Optional[List[str]] = None,
               train: bool = True,
               progress=None, *, device="cuda") -> List[ProgramSpec]:
    """Specs for the whole arch grid plus the arch-independent Soft-MoE
    kernel program."""
    specs: List[ProgramSpec] = []
    for arch in archs or GRID:
        if progress:
            progress(f"building specs: {arch}")
        specs += build_program_specs(arch, train=train, device=device)
    specs += kernel_program_specs(device=device)
    return specs
