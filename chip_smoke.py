#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits 1 and
prints no result line):

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit; turns TF32 off for matmuls and cuDNN.
2. build: compiles every CUDA source of the port with nvcc (one process
   per source, started together) and prints the build time.
3. kernels: holds each kernel against its plain PyTorch version on the
   card (ragged tables, null-block entries, an inactive row, subdivided
   pool blocks, GQA at two widths, a sliding window), checks that a
   batched launch equals the batch-1 launches bitwise and that malformed
   operands raise, and times the kernel, its plain version and one
   PyTorch library call at the serving path's shapes.
4. soft-moe kernels: holds K1 (routing), K2 (combine from K1's stats)
   and K3 (online combine) against their plain PyTorch versions on the
   card at the Soft-MoE B/16 layer's shapes and at ragged ones (a token
   count that is not a multiple of the token block, the S/14-256E shape
   over several slot blocks, a single row, f32 inputs, a d narrower
   than its chunk, L/16's d = 1024 over two d-chunks, the granite LM
   layer's m = 2048, d = 1024, S = 32), checks batched ==
   batch-1 bitwise, that K2 on K1's stats agrees with K3 and K3's stats
   with K1's, and that malformed operands raise; then times each kernel,
   its plain version, one ``scaled_dot_product_attention`` call that
   computes its main output (the library yardstick) and the port's
   unfused einsum path of the same function, and reads each one's peak
   device memory above its inputs; K1 and K2 are also timed at the
   granite layer's shapes beside the same SDPA call and einsum path.
5. soft-moe backward kernels: holds K4 (dispatch backward) and K5
   (combine backward) against their plain PyTorch versions on the card at
   the B/16 layer in bf16 and f32, a ragged case (m = 45, d = 264, S = 40,
   also at 16 x 8 blocks), L/16's d = 1024, a case over several token
   chunks (``tuning.BWD_TILES`` token blocks, 64 tokens by default) with
   a ragged last one and over two 128-slot tiles (m = 300, d = 264, S =
   150) and the granite layer (m = 2048, d = 1024, S = 32), with the
   forward residuals from K1 and K2; checks that dX and dYs of a batched
   call equal batch-1 calls bitwise, that dPhi_n equals the row-order
   sum of the batch-1 dPhi_n's and is bitwise the same over two runs,
   and that malformed operands raise; then, at the B/16 and the granite
   layer, times each kernel beside its bound at the f32 rate and the
   bound of the work its tensor-core design runs, its plain version, the
   backward of the ``scaled_dot_product_attention`` call of phase 4 (the
   library yardstick) and the einsum path's backward, and profiles one
   call's device time by launch. The build prints each body's
   registers, shared memory and spills (ptxas).
6. routing health: holds K6 (the Fig. 9 routing-health reductions from
   K1's saved stats) against its plain PyTorch version and against the
   chunked oracle ``core.inspection.routing_health_from_stats`` on the
   card at the granite-moe-1b-a400m+soft layer (b = 8, m = 2048, d = 1024,
   S = 32) and the B/16 layer, in bf16 and f32, and at a ragged case over
   several slot blocks; checks batched == batch-1 and run-to-run bitwise
   and that malformed operands raise; then times the kernel beside its
   bound, its plain version and the einsum path of the same reductions
   (no single PyTorch call computes them).
7. serve: full-width qwen2-0.5b (24 layers, random weights from a seeded
   generator, bf16 compute) answers 16 greedy requests through
   ``ServeEngine(backend="paged")``; the kernel's launch count must equal
   decode steps x 24. A second kernel engine then runs the same requests,
   and a burst of 8 short ones that keeps every slot decoding, tick by
   tick beside a gather-path engine (``use_kernel=False``), teacher
   forced: the logits of every decoding row at every tick are held
   against the gather engine's.
8. vit: full-width, full-depth soft-moe-b/16-128e (random f32 weights from
   a seeded generator, bf16 compute) classifies a batch of 64 images
   through ``vit_apply`` / ``vit_features`` on the kernel path and on the
   einsum path under ``torch.inference_mode()``: K1 and K2 must launch 6
   times a forward and K3 never; the kernel path's pre-head features and
   one MoE layer's output are held against the einsum path's in bf16 and
   in f32 (the layer's input is captured from the model's own forward);
   then images/s, forward p50 and peak memory for each path, and a
   profiled window.
   K3 runs on the ops-level path that combines without saved stats
   (``kernels.ops.soft_moe_combine(..., c_stats=None)``), driven on one
   MoE layer and held against the layer's kernel path.
9. train: full-width, full-depth soft-moe-b/16-128e training steps through
   ``train.make_train_step`` (batch 64 of ``data.SyntheticImages``, bf16
   compute, f32 params and AdamW moments, remat as the config sets it,
   the optimizer of ``examples/train_vit_softmoe.py``): the step-0 loss
   is ln 1000 (the head starts at zero); K1 and K2 launch 12 times a step
   and K4 and K5 6 times; at step 1 the kernel path's gradients of every
   MoE layer's phi and scale and of one expert leaf are held against the
   einsum path's in bf16 and in f32, and one MoE layer's whole gradient
   in f32; then the step time p50 over 7 steps, images/s, peak device
   memory, a profiled step, and a checkpoint round trip of one MoE
   layer's train state through ``checkpoint.CheckpointManager``, restored
   bitwise.
10. lm train: full-width, full-depth granite-moe-1b-a400m+soft (24 Soft-MoE
   layers of 32 one-slot experts, random f32 weights from a seeded
   generator, bf16 compute, f32 AdamW moments, remat and scan_layers as
   the config sets them) trains on batch 8 x 2048 tokens of
   ``data.SyntheticLM`` through ``lm_loss(use_kernel=True,
   telemetry=True)``, ``make_train_step`` and the ``Trainer``, which logs
   the flattened telemetry every step: at step 0 the kernel path's loss
   and every layer's telemetry are held against the einsum path's in
   bf16, and one MoE layer's telemetry in f32; the launches a step must
   be K1 48, K2 48, K4 24, K5 24, K6 24 (one a MoE layer: the remat
   recompute takes no telemetry) and K3 0; then step p50, tokens/s and
   peak memory over 7 Trainer steps (which end in a save of the whole
   train state), step p50 with telemetry on and off in turns, and a
   profiled step with K6's share of device time.

The lines before the last carry the numbers: the card line as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
it, and one JSON object ``{"kernels": [...]}``. The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the
# float32 rate outside the tensor cores (the TPU kernels' arithmetic),
# and the dense tensor-core rates of TF32 and bf16.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

KERNEL_SOURCES = {
    "paged_decode_attend": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_attention_kernels.py:118",
    },
    "routing_fwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_routing.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:183",
    },
    "combine_apply": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_combine.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:456",
    },
    "combine_online": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_combine.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:462",
    },
    "dispatch_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_dispatch_bwd.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:529",
    },
    "combine_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_combine_bwd.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:658",
    },
    "routing_health": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/soft_moe_routing_health.cu",
        "replaces": "src/repro/kernels/soft_moe_kernels.py:294",
    },
}


def log(msg=""):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    res = build.build()
    log(f"[build] {len(res)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s wall")
    for name, r in res.items():
        log(f"[build] {name}: {r['seconds']:.2f} s -> {r['path']}")
        fn = ""
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                fn = kernel_label(line)
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {fn}: {line.strip()}")


def kernel_label(line):
    """'name<bf16|f32, d-chunk>' from ptxas's 'Compiling entry function'
    line (a mangled name: its nested identifiers, each prefixed by its
    length, then its template arguments: the element type and, for the
    Soft-MoE kernels, the d-chunk's 128-column count (K1-K3) or the slot
    tile's 32-slot count (K4, K5))."""
    import re

    mangled = line.split("'")[1] if "'" in line else line
    names, pos = [], 2 + (mangled[2:3] == "N")  # after _Z or _ZN
    while pos < len(mangled) and mangled[pos].isdigit():
        digits = re.match(r"\d+", mangled[pos:]).group()
        n = int(digits)
        names.append(mangled[pos + len(digits):pos + len(digits) + n])
        pos += len(digits) + n
    label = next((x for x in names if x.endswith("_kernel")), mangled[:48])
    rest = mangled[pos:]
    args = []
    if "__nv_bfloat16" in rest:
        args.append("bf16")
    elif rest.startswith("If"):
        args.append("f32")
    nv = re.search(r"Li(\d+)E", rest)
    if nv and label.endswith("bwd_kernel"):  # K4/K5: the slot tile
        args.append(f"slot tile {32 * int(nv.group(1))}")
    elif nv and not label.startswith("paged"):  # K7's is the head dim
        args.append(f"d-chunk {128 * int(nv.group(1))}")
    return label + (f"<{', '.join(args)}>" if args else "")


# ---------------------------------------------------------------------------
# phase 3: paged decode attention against its plain version
# ---------------------------------------------------------------------------


def make_paged_case(torch, seed, B, H, G, D, block_size, max_tokens, dtype,
                    lens):
    """Random pool with ragged per-row tables: physical blocks handed out
    top-down (not in logical order), a null-block hole in row 1's table,
    null entries past each row's end, and rows with len < 0 inactive."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nb = max_tokens // block_size
    nblk = B * nb + 1
    k = torch.randn(nblk, block_size, G, D, generator=gen, device="cuda")
    v = torch.randn(nblk, block_size, G, D, generator=gen, device="cuda")
    q = torch.randn(B, H, D, generator=gen, device="cuda")
    pos = torch.full((nblk, block_size), -1, dtype=torch.int32)
    tables = torch.zeros((B, nb), dtype=torch.int32)
    nxt = nblk - 1
    for r, ln in enumerate(lens):
        for lb in range(-(-ln // block_size) if ln > 0 else 0):
            if r == 1 and lb == 1:
                continue  # null-block hole: those positions were never written
            tables[r, lb] = nxt
            n = min(block_size, ln - lb * block_size)
            pos[nxt, :n] = torch.arange(lb * block_size, lb * block_size + n,
                                        dtype=torch.int32)
            nxt -= 1
    qpos = torch.tensor([ln - 1 if ln > 0 else -1 for ln in lens],
                        dtype=torch.int32)
    return (q.to(dtype), k.to(dtype), v.to(dtype), pos.cuda(), tables.cuda(),
            qpos.cuda())


def paged_bound_ms(q, k, tables, qpos, block_size):
    """Least time on the card: bytes each input/output must move (live
    keys only) over HBM bandwidth vs flops over the f32 rate."""
    B, H, D = q.shape
    G = k.shape[2]
    el = k.element_size()
    live = [int(p) + 1 for p in qpos.tolist() if p >= 0]
    keys = sum(live)
    blocks = sum(-(-n // block_size) for n in live)
    nbytes = (q.numel() * q.element_size()          # q
              + keys * (2 * G * D * el + 4)         # K, V, pos of live keys
              + blocks * 4 + B * 4                  # live table entries, q_pos
              + B * H * D * q.element_size())       # output
    flops = keys * H * 4 * D                        # q.k and p.v per head
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops
            else "operations")


def time_ms(torch, fn, reps=30, flush=None):
    """Median device time of fn() (CUDA events), with L2 flushed before
    every call when ``flush`` (a large tensor) is given: the serving path
    reads a different layer's pool at every call. Each call is queued
    behind a 2 ms device sleep, so the host has enqueued it before the
    start event fires and the events read device time only (for a
    host-bound ``fn`` its host time still shows)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(4_000_000)  # ~2 ms at the H100's clock
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase_kernels(torch):
    from repro_torch.kernels.paged_attention import (
        paged_decode_attend,
        paged_decode_attend_ref,
    )
    from repro_torch.kernels.tuning import KernelConfig

    # (atol, rtol) of |out - ref| <= atol + rtol |ref|, elementwise. In
    # bf16 both sides agree in f32 and then round to bf16, so they differ
    # by at most one bf16 step of the output, 2^-7 |ref|.
    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0**-7)}
    lens8 = [2048, 1500, 1024, 700, 300, 17, -1, 5]
    long_rows = [r for r, n in enumerate(lens8) if n >= 1024]
    cases = [
        # (label, B, H, G, D, block_size, dtype, window, is_global, cfg)
        ("slice bf16", 8, 14, 2, 64, 16, torch.bfloat16, None, True, None),
        ("slice f32", 8, 14, 2, 64, 16, torch.float32, None, True, None),
        ("slice f32 bkv=8", 8, 14, 2, 64, 16, torch.float32, None, True,
         KernelConfig(paged_block_kv=8)),
        ("block 192 f32", 8, 14, 2, 64, 192, torch.float32, None, True,
         None),
        ("H32 G8 D128 bf16", 8, 32, 8, 128, 16, torch.bfloat16, None, True,
         None),
        ("H32 G8 D128 f32", 8, 32, 8, 128, 16, torch.float32, None, True,
         None),
        ("window local bf16", 8, 14, 2, 64, 16, torch.bfloat16, 1024, False,
         None),
        ("window local f32", 8, 14, 2, 64, 16, torch.float32, 1024, False,
         None),
        ("window global f32", 8, 14, 2, 64, 16, torch.float32, 1024, True,
         None),
    ]
    main = {}
    for i, (label, B, H, G, D, bs, dt, window, is_global, kcfg) in \
            enumerate(cases):
        max_tokens = 2112 if bs == 192 else 2048
        args = make_paged_case(torch, i, B, H, G, D, bs, max_tokens, dt,
                               lens8)
        kw = dict(window=window, is_global=is_global, cfg=kcfg)
        out = paged_decode_attend(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_decode_attend_ref(*args, **kw)
        atol, rtol = tol[dt]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        within = bool((diff <= atol + rtol * ref.float().abs()).all())
        long_err = diff[long_rows].max().item()
        long_mag = ref[long_rows].float().abs().mean().item()
        finite = bool(torch.isfinite(out).all())
        inactive_zero = bool((out[6] == 0).all())
        rows = torch.cat([
            paged_decode_attend(*(a[r:r + 1] if j in (0, 4, 5) else a
                                  for j, a in enumerate(args)), **kw)
            for r in range(B)
        ])
        bitwise = torch.equal(rows, out)
        ok = within and finite and inactive_zero and bitwise
        log(f"[kernel] paged_decode_attend {label}: B={B} H={H} G={G} D={D} "
            f"block={bs} window={window} is_global={is_global} "
            f"max_abs_err={err:.3e} (tol {atol:.0e} + {rtol:.4g}|ref|: "
            f"{within}) rows of >=1024 tokens: max_abs_err={long_err:.3e}, "
            f"mean |out| {long_mag:.3e}; finite={finite} "
            f"inactive_row_zero={inactive_zero} "
            f"batched==batch1_bitwise={bitwise}")
        if not ok:
            raise AssertionError(f"paged_decode_attend {label} failed")
        if label == "slice bf16":
            main = {"args": args, "err": err}

    # No fallback: malformed operands raise and launch nothing.
    q, k, v, pos, tables, qpos = main["args"]
    before = paged_decode_attend.launches
    for bad, why in (
        ((q, k.half(), v.half(), pos, tables, qpos), "float16 pool"),
        ((q, k.transpose(1, 2).contiguous().transpose(1, 2), v, pos,
          tables, qpos), "non-contiguous pool"),
        ((q, k, v, pos.long(), tables, qpos), "int64 positions"),
        ((*(t[..., :60].contiguous() for t in (q, k, v)), pos, tables, qpos),
         "head dim 60: 120 bytes, not whole 16-byte loads"),
        ((q, torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")[1:]
          .view(k.shape).copy_(k), v, pos, tables, qpos),
         "pool 2 bytes past a 16-byte boundary"),
    ):
        try:
            paged_decode_attend(*bad)
        except (TypeError, ValueError) as e:
            log(f"[kernel] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if paged_decode_attend.launches != before:
        raise AssertionError("a malformed call launched the kernel")

    # Times at the serving path's shapes (B=8, H=14, G=2, D=64, block 16).
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    kernel_ms = time_ms(torch, lambda: paged_decode_attend(*main["args"]),
                        flush=flush)
    plain_ms = time_ms(torch, lambda: paged_decode_attend_ref(*main["args"]),
                       reps=5, flush=flush)
    B, H, D = q.shape
    G = k.shape[2]
    nb, bs = tables.shape[1], k.shape[1]
    idx = tables.long()
    kv_view = [t[idx].reshape(B, nb * bs, G, D) for t in (k, v)]
    kpos = pos[idx].reshape(B, nb * bs)
    mask = ((kpos >= 0) & (kpos <= qpos[:, None].long()))[:, None, None, :]
    # G key/value heads, as the kernel reads them; SDPA groups the queries
    kg, vg = (t.transpose(1, 2).contiguous() for t in kv_view)
    qh = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(
        torch, lambda: sdpa(qh, kg, vg, attn_mask=mask, enable_gqa=True),
        flush=flush)
    bound_ms, bound_by = paged_bound_ms(q, k, tables, qpos, bs)
    log(f"[kernel] paged_decode_attend timing (B=8 H=14 G=2 D=64 block 16, "
        f"bf16, L2 flushed): kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms(sdpa with enable_gqa over the "
        f"gathered view)={library_ms:.4f} bound={bound_ms * 1e3:.3f} us "
        f"({bound_by})")
    return {"paged_decode_attend": {
        "max_abs_err": main["err"], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }}


# ---------------------------------------------------------------------------
# phase 4: Soft-MoE routing and combine kernels against their plain versions
# ---------------------------------------------------------------------------


def soft_moe_case(torch, seed, b, m, d, s, dtype):
    """x (b, m, d), ys (b, S, d) in ``dtype``; phi_n (d, S) f32
    normalized with scale 1 (the ViT's init), all on the card."""
    from repro_torch.kernels.ref import normalized_phi

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, m, d, generator=gen, device="cuda").to(dtype)
    phi = torch.randn(d, s, generator=gen, device="cuda")
    ys = torch.randn(b, s, d, generator=gen, device="cuda").to(dtype)
    return x, normalized_phi(phi, 1.0), ys


def within(torch, got, want, atol, rtol):
    """(max |got - want|, all |got - want| <= atol + rtol |want|)."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= atol + rtol * want.float().abs())
                                   .all())


def soft_moe_bounds(x, s, kind):
    """Least time on the card for one call: the bytes each input and output
    must move over HBM bandwidth vs the f32 flops (the logits 2 m S d, the
    mix 2 m S d, the norms 2 m d per row) over the f32 rate."""
    b, m, d = x.shape
    el = x.element_size()
    tokens = b * m * d * el                        # x in (and y out for K2/K3)
    slots = b * s * d * el                         # slots out / ys in
    phi = d * s * 4
    if kind == "routing":
        nbytes = tokens + phi + slots + 2 * b * s * 4 + 2 * b * m * 4
    else:  # combine: x, phi, ys, stats in or out, y
        nbytes = 2 * tokens + phi + slots + 2 * b * m * 4
    flops = b * (4 * m * s * d + 2 * m * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def softmoe_yardsticks(torch, x, phi_n, ys, flush, shape):
    """The yardsticks of K1-K3 on these operands: ({kind: sdpa_options(...)},
    {kind: the einsum path's call}) for kind "routing" and "combine"; logs
    each backend's time, why the others refused, and the l2norm pre-pass.

    The library yardstick: one scaled_dot_product_attention call computes
    each kernel's main output. Dispatch (K1's slots) is SDPA(q = Phi_n^T,
    k = l2norm(x), v = x), a softmax over tokens per slot; combine (K2/K3's
    y) is SDPA(q = l2norm(x), k = Phi_n^T, v = Ys), a softmax over slots
    per token; scale 1. SDPA takes one dtype, so Phi_n is cast to x's. The
    operands are made before the timed call; l2norm(x) is the O(b m d)
    pre-pass the kernels also run, timed on its own. Each backend is tried
    on Phi_n^T broadcast over the rows and copied per row, and the fastest
    call that runs is the yardstick. The einsum path is the port's unfused
    path of the same functions (use_kernel=False in core/soft_moe.py): the
    (b, m, S) weights, then the dispatch or the combine einsum."""
    from repro_torch.core.soft_moe import soft_moe_weights

    b, m, d = x.shape
    s = phi_n.shape[1]

    def l2norm():
        xf = x.float()
        return (xf / (xf.norm(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)

    xn4, x4, ys4 = l2norm()[:, None], x[:, None], ys[:, None]
    phi_b = phi_n.t().contiguous().to(x.dtype)[None, None].expand(b, 1, s,
                                                                  d)
    layouts = {"broadcast": phi_b, "copied": phi_b.contiguous()}
    library = {
        "routing": sdpa_options(torch, {k: (ph, xn4, x4)
                                        for k, ph in layouts.items()}, flush),
        "combine": sdpa_options(torch, {k: (xn4, ph, ys4)
                                        for k, ph in layouts.items()}, flush),
    }
    norm_ms = time_ms(torch, l2norm, flush=flush)
    for kind, (default, runs, refused) in library.items():
        log(f"[softmoe] sdpa for {kind} ({shape}): "
            f"default pick {default}; runs: "
            + "; ".join(f"{k} {ms:.4f} ms" for k, (ms, _) in runs.items())
            + f"; l2norm pre-pass {norm_ms:.4f} ms; refused: "
            + "; ".join(f"{k}: {why}" for k, why in refused.items()))

    phi3 = phi_n.reshape(d, s, 1)
    one = torch.ones((), device="cuda")

    def einsum_routing():
        d_w, _ = soft_moe_weights(x, phi3, one)
        return torch.einsum("bmd,bmnp->bnpd", x.float(), d_w).to(x.dtype)

    def einsum_combine():
        _, c_w = soft_moe_weights(x, phi3, one)
        return torch.einsum("bnpd,bmnp->bmd", ys.float().reshape(b, s, 1, d),
                            c_w).to(x.dtype)

    return library, {"routing": einsum_routing, "combine": einsum_combine}


def phase_soft_moe_kernels(torch):
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_apply_ref,
        combine_online,
        combine_online_ref,
        routing_fwd,
        routing_fwd_ref,
    )
    from repro_torch.kernels.tuning import KernelConfig, d_chunk

    # Elementwise |out - ref| <= atol + rtol |ref|. Outputs: f32 within
    # 1e-5 relative; bf16 within one bf16 step, 2^-7 |ref| (both sides
    # agree in f32 and then round). Softmax stats are f32 on both sides.
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0**-7)}
    stat_tol = (1e-5, 1e-5)
    cases = [
        # (label, b, m, d, S, dtype, cfg); m = 196 is not a multiple of
        # the 32-token block
        ("B/16 layer bf16", 64, 196, 768, 128, torch.bfloat16, None),
        ("B/16 layer f32", 64, 196, 768, 128, torch.float32, None),
        ("S/14-256E bf16", 8, 256, 384, 256, torch.bfloat16, None),
        ("S/14-256E f32 bt16 bs8", 8, 256, 384, 256, torch.float32,
         KernelConfig(block_tokens=16, block_slots=8)),
        ("single row bf16", 1, 196, 768, 128, torch.bfloat16, None),
        # 264 of a 384-column chunk's columns lie inside d
        ("ragged m45 d264 S40 f32", 3, 45, 264, 40, torch.float32, None),
        # L/16's width: two 768-column chunks, each recomputing the logits
        ("L/16 layer d1024 bf16", 8, 196, 1024, 128, torch.bfloat16, None),
        # granite-moe-1b-a400m+soft's layer at seq 2048: 64 token blocks,
        # one slot block, two d-chunks
        ("granite layer bf16", 8, 2048, 1024, 32, torch.bfloat16, None),
    ]
    main, granite = {}, None
    for i, (label, b, m, d, s, dt, kcfg) in enumerate(cases):
        x, phi_n, ys = soft_moe_case(torch, 100 + i, b, m, d, s, dt)
        atol, rtol = tol[dt]
        slots, d_stats, c_stats = routing_fwd(x, phi_n, kcfg)
        y2 = combine_apply(x, phi_n, ys, c_stats, kcfg)
        y3, st3 = combine_online(x, phi_n, ys, kcfg)
        torch.cuda.synchronize()
        r_slots, r_d, r_c = routing_fwd_ref(x, phi_n, kcfg)
        r_y2 = combine_apply_ref(x, phi_n, ys, c_stats, kcfg)
        r_y3, r_st3 = combine_online_ref(x, phi_n, ys, kcfg)
        errs, oks = {}, []
        for name, got, want, (a, r) in (
                ("K1 slots", slots, r_slots, (atol, rtol)),
                ("K1 d_mx", d_stats[0], r_d[0], stat_tol),
                ("K1 d_den", d_stats[1], r_d[1], stat_tol),
                ("K1 c_mx", c_stats[0], r_c[0], stat_tol),
                ("K1 c_den", c_stats[1], r_c[1], stat_tol),
                ("K2 y", y2, r_y2, (atol, rtol)),
                ("K3 y", y3, r_y3, (atol, rtol)),
                ("K3 c_mx", st3[0], r_st3[0], stat_tol),
                ("K3 c_den", st3[1], r_st3[1], stat_tol),
                # K2 on K1's stats vs K3; K3's stats vs K1's
                ("K2 vs K3 y", y2, y3, (atol, rtol)),
                ("K3 vs K1 c_mx", st3[0], c_stats[0], stat_tol),
                ("K3 vs K1 c_den", st3[1], c_stats[1], stat_tol)):
            errs[name], ok = within(torch, got, want, a, r)
            oks.append(ok)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (slots, y2, y3, *d_stats, *c_stats, *st3))
        # batched == batch-1, bitwise, on the first, second and last rows
        bitwise = True
        for r in sorted({0, min(1, b - 1), b - 1}):
            xr, yr = x[r:r + 1], ys[r:r + 1]
            sr, dr, cr = routing_fwd(xr, phi_n, kcfg)
            bitwise &= torch.equal(sr[0], slots[r])
            bitwise &= all(torch.equal(g[0], w[r])
                           for g, w in zip(dr + cr, d_stats + c_stats))
            cr_r = tuple(t[r:r + 1] for t in c_stats)
            bitwise &= torch.equal(combine_apply(xr, phi_n, yr, cr_r,
                                                 kcfg)[0], y2[r])
            y3r, st3r = combine_online(xr, phi_n, yr, kcfg)
            bitwise &= torch.equal(y3r[0], y3[r])
            bitwise &= all(torch.equal(g[0], w[r])
                           for g, w in zip(st3r, st3))
        log(f"[softmoe] {label}: b={b} m={m} d={d} S={s} "
            f"{str(dt).replace('torch.', '')} d_chunk={d_chunk(d)} "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f" (tol outputs {atol:.0e} + {rtol:.4g}|ref|, stats "
            f"{stat_tol[0]:.0e} + {stat_tol[1]:.0e}|ref|: {all(oks)}); "
            f"finite={finite} batched==batch1_bitwise={bitwise}")
        if not (all(oks) and finite and bitwise):
            raise AssertionError(f"soft-moe kernels {label} failed")
        if label.startswith("granite"):
            granite = (x, phi_n, ys, c_stats)
        if i == 0:
            main = {"args": (x, phi_n, ys), "c_stats": c_stats,
                    "err": {"routing_fwd": max(errs[k] for k in errs
                                               if k.startswith("K1")),
                            "combine_apply": errs["K2 y"],
                            "combine_online": max(errs["K3 y"],
                                                  errs["K3 c_mx"],
                                                  errs["K3 c_den"])}}

    # No fallback: malformed operands raise and launch nothing.
    x, phi_n, ys = main["args"]
    counts = lambda: (routing_fwd.launches, combine_apply.launches,  # noqa: E731
                      combine_online.launches)
    before = counts()
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    for call, exc, why in (
            (lambda: routing_fwd(x.half(), phi_n), TypeError, "float16 x"),
            (lambda: routing_fwd(x, phi_n.double()), TypeError,
             "float64 phi_n"),
            (lambda: combine_online(x, phi_n, ys.float()), TypeError,
             "ys dtype != x dtype"),
            (lambda: routing_fwd(x.transpose(1, 2).contiguous()
                                 .transpose(1, 2), phi_n), ValueError,
             "non-contiguous x"),
            (lambda: routing_fwd(x[..., :764].contiguous(),
                                 phi_n[:764].contiguous()), ValueError,
             "d=764, not a multiple of 8"),
            (lambda: routing_fwd(shifted, phi_n), ValueError,
             "x 2 bytes past a 16-byte boundary"),
            (lambda: routing_fwd(x, phi_n, KernelConfig(block_tokens=64)),
             ValueError, "block_tokens=64 > 32"),
            (lambda: combine_apply(x, phi_n, ys, (main["c_stats"][0][:, :5],
                                                  main["c_stats"][1])),
             ValueError, "stats of the wrong shape"),
            (lambda: routing_fwd(x, phi_n.clone().requires_grad_()),
             NotImplementedError, "phi_n requires grad (a raw kernel has no "
             "backward)")):
        try:
            call()
        except exc as e:
            log(f"[softmoe] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if counts() != before:
        raise AssertionError("a malformed call launched a kernel")

    # Times at the B/16 layer's shapes (b=64, m=196, d=768, S=128, bf16).
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    c_stats = main["c_stats"]
    calls = {
        "routing_fwd": (lambda: routing_fwd(x, phi_n),
                        lambda: routing_fwd_ref(x, phi_n), "routing"),
        "combine_apply": (lambda: combine_apply(x, phi_n, ys, c_stats),
                          lambda: combine_apply_ref(x, phi_n, ys, c_stats),
                          "combine"),
        "combine_online": (lambda: combine_online(x, phi_n, ys),
                           lambda: combine_online_ref(x, phi_n, ys),
                           "combine"),
    }
    b, m, d = x.shape
    s = phi_n.shape[1]
    library, einsum = softmoe_yardsticks(torch, x, phi_n, ys, flush,
                                         "b=64 m=196 d=768 S=128 bf16")

    def peak_above(fn):
        """Peak device bytes fn() allocates above what is live before."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    out = {}
    for name, (kern, plain, kind) in calls.items():
        want = kern()[0] if name != "combine_apply" else kern()
        label, (library_ms, lib_call) = min(library[kind][1].items(),
                                            key=lambda r: r[1][0])
        lib_err = (lib_call()[:, 0].float() - want.float()).abs().max().item()
        if lib_err > 2e-2:  # the yardstick must compute the same function
            raise AssertionError(f"sdpa ({label}) differs from {name} by "
                                 f"{lib_err:.3e}")
        kernel_ms = time_ms(torch, kern, flush=flush)
        plain_ms = time_ms(torch, plain, reps=3, flush=flush)
        einsum_ms = time_ms(torch, einsum[kind], flush=flush)
        mem = {k: peak_above(f) / 2**20 for k, f in (
            ("kernel", kern), ("sdpa", lib_call), ("einsum", einsum[kind]))}
        bound_ms, bound_by, nbytes, flops = soft_moe_bounds(x, s, kind)
        log(f"[softmoe] {name} timing (b=64 m=196 d=768 S=128 bf16, L2 "
            f"flushed): kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (scaled_dot_product_attention, "
            f"{label}; max|sdpa - kernel| {lib_err:.3e}) "
            f"einsum_path_ms={einsum_ms:.4f} (the port's unfused path) "
            f"bound={bound_ms * 1e3:.2f} us ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) -> "
            f"{flops / kernel_ms / 1e9:.2f} TFLOP/s; peak MiB above the "
            f"inputs: kernel {mem['kernel']:.1f}, sdpa {mem['sdpa']:.1f}, "
            f"einsum path {mem['einsum']:.1f}")
        out[name] = {"max_abs_err": main["err"][name], "ms": kernel_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "einsum_path_ms": einsum_ms}

    # K1 and K2 at the granite layer's shapes, as the LM training phase
    # runs them (b=8, m=2048, d=1024, S=32, bf16): 16 CTAs for K1's main
    # kernel, two d-chunks; beside the same yardsticks as at B/16
    gx, gphi, gys, gstats = granite
    shape = "b=8 m=2048 d=1024 S=32 bf16"
    library, einsum = softmoe_yardsticks(torch, gx, gphi, gys, flush, shape)
    for name, kern, kind in (
            ("routing_fwd", lambda: routing_fwd(gx, gphi), "routing"),
            ("combine_apply", lambda: combine_apply(gx, gphi, gys, gstats),
             "combine")):
        want = kern()[0] if name == "routing_fwd" else kern()
        label, (library_ms, lib_call) = min(library[kind][1].items(),
                                            key=lambda r: r[1][0])
        lib_err = (lib_call()[:, 0].float() - want.float()).abs().max().item()
        if lib_err > 2e-2:
            raise AssertionError(f"sdpa ({label}) differs from {name} at "
                                 f"the granite layer by {lib_err:.3e}")
        bound_ms, bound_by, nbytes, flops = soft_moe_bounds(
            gx, gphi.shape[1], kind)
        ms = time_ms(torch, kern, flush=flush)
        einsum_ms = time_ms(torch, einsum[kind], flush=flush)
        log(f"[softmoe] {name} timing at the granite layer ({shape}, L2 "
            f"flushed): kernel_ms={ms:.4f} library_ms={library_ms:.4f} "
            f"(scaled_dot_product_attention, {label}; max|sdpa - kernel| "
            f"{lib_err:.3e}) einsum_path_ms={einsum_ms:.4f} "
            f"bound={bound_ms * 1e3:.2f} us ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) -> "
            f"{flops / ms / 1e9:.2f} TFLOP/s")
        out[name]["granite"] = {"ms": ms, "bound_ms": bound_ms,
                                "library_ms": library_ms,
                                "einsum_path_ms": einsum_ms}
    return out


def sdpa_options(torch, operands, flush):
    """Time one scaled_dot_product_attention call (scale 1) on each
    operand layout in ``operands`` ({layout: (q, k, v)}) under each
    backend that takes it. Returns (the backend PyTorch picks by default
    for the first layout, {"BACKEND, layout": (ms, call)}, {"BACKEND,
    layout": why it refused})."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    default = sdp_backend(torch, *next(iter(operands.values())))
    runs, refused = {}, {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for layout, qkv in operands.items():
            def call(qkv=qkv, be=be):
                with sdpa_kernel([be]):
                    return sdpa(*qkv, scale=1.0)

            key = f"{be.name}, {layout}"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    call()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    why = [str(w.message).split(" (Triggered internally")[0]
                           for w in caught]
                    why = [w for w in why if not w.endswith("because:")]
                    refused[key] = " | ".join(why or [str(e)])[:400]
                    continue
            runs[key] = (time_ms(torch, call, flush=flush), call)
    return default, runs, refused


def sdp_backend(torch, q, k, v):
    """Name of the backend scaled_dot_product_attention picks for these
    operands (a private query of PyTorch's; "unknown" where it is not
    there)."""
    try:
        idx = torch._fused_sdp_choice(q, k, v, None, 0.0, False, scale=1.0)
        from torch.nn.attention import SDPBackend
        return next(n for n, e in SDPBackend.__members__.items()
                    if int(e.value) == int(idx))
    except (AttributeError, ImportError, RuntimeError, StopIteration,
            TypeError):
        return "unknown"


# ---------------------------------------------------------------------------
# phase 5: the Soft-MoE backward kernels (K4, K5) against their plain versions
# ---------------------------------------------------------------------------


def soft_moe_bwd_bounds(x, s, kind):
    """Least time on the card for one backward call: the bytes the kernel's
    own operands must move (x, Phi_n, the gradient, the stats and the
    sigma / rho row terms in; dX, dPhi_n and, for K5, Ys in and dYs out)
    over HBM bandwidth vs the least f32 flops, 10 m S d a row (the logits,
    x . g or g . Ys, and three products), over the f32 rate."""
    b, m, d = x.shape
    el = x.element_size()
    tokens, slots, phi = b * m * d * el, b * s * d * el, d * s * 4
    if kind == "dispatch":  # x, g_slots in; dx out; stats and sigma (b, S)
        nbytes = 2 * tokens + slots + 2 * phi + 3 * b * s * 4
    else:  # x, g, ys in; dx, dys out; stats and rho (b, m)
        nbytes = 3 * tokens + 2 * slots + 2 * phi + 3 * b * m * 4
    flops = b * 10 * m * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def soft_moe_bwd_design_bound(x, s, kind):
    """Least time on the card for the work the tensor-core design of K4
    and K5 runs (csrc/soft_moe_bwd.cuh): its five products of 2 m S d
    flops a row each, as passes on the tensor cores at their dense peaks
    (bf16 x: the bf16 x . g or g . Ys product one bf16 pass, the other
    four 9 TF32 passes; f32 x: 14 TF32 passes), against the bytes of
    soft_moe_bwd_bounds plus the chunk partials (b, n_chunks, S, d) f32,
    written once and read once (K4: dPhi_n's; K5: dPhi_n's and dYs')."""
    from repro_torch.kernels.tuning import BWD_TILES, default_config

    b, m, d = x.shape
    unit = 2.0 * b * m * s * d
    if x.element_size() == 2:
        t_ops = 9 * unit / TF32_FLOPS + unit / BF16_FLOPS
    else:
        t_ops = 14 * unit / TF32_FLOPS
    ct = BWD_TILES * default_config(m, d, s).block_tokens
    part = b * -(-m // ct) * s * d * 4
    nbytes = (soft_moe_bwd_bounds(x, s, kind)[2]
              + 2 * part * (1 if kind == "dispatch" else 2))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, t_ops)


def bwd_case(torch, seed, b, m, d, s, dtype, cfg):
    """The backward kernels' operands on the card: the forward's residuals
    from K1 and K2 (slots, both stats pairs, y) and random gradients."""
    from repro_torch.kernels.soft_moe_kernels import combine_apply, routing_fwd

    x, phi_n, ys = soft_moe_case(torch, seed, b, m, d, s, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    g_slots = torch.randn(b, s, d, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, m, d, generator=gen, device="cuda").to(dtype)
    with torch.no_grad():
        slots, d_stats, c_stats = routing_fwd(x, phi_n, cfg)
        y = combine_apply(x, phi_n, ys, c_stats, cfg)
    return dict(x=x, phi_n=phi_n, ys=ys, g_slots=g_slots, g=g, slots=slots,
                d_stats=d_stats, c_stats=c_stats, y=y)


def phase_soft_moe_bwd_kernels(torch):
    from repro_torch.kernels.soft_moe_kernels import (
        combine_bwd,
        combine_bwd_ref,
        dispatch_bwd,
        dispatch_bwd_ref,
    )
    from repro_torch.kernels.tuning import (
        BWD_TILES,
        KernelConfig,
        default_config,
    )

    # Tolerances, on max |got - want| / max |want| per output: f32 within
    # 1e-5 (the two sides sum in other orders); bf16 outputs elementwise
    # within one bf16 step of the plain version's, 2^-7 |want|, plus the
    # f32 tolerance 1e-5 max |want| (both sides agree in f32, then round;
    # an element that cancels to near 0 keeps only the f32 agreement).
    # dPhi_n is f32 in every case.
    cases = [
        # (label, b, m, d, S, dtype, cfg); m = 196 is not a multiple of
        # the 32-token block
        ("B/16 layer bf16", 64, 196, 768, 128, torch.bfloat16, None),
        ("B/16 layer f32", 64, 196, 768, 128, torch.float32, None),
        # 264 of a 384-column chunk's columns lie inside d; a ragged
        # last slot block (40 = 32 + 8) and token block (45 = 32 + 13)
        ("ragged m45 d264 S40 f32", 3, 45, 264, 40, torch.float32, None),
        ("ragged m45 d264 S40 bf16 bt16 bs8", 3, 45, 264, 40,
         torch.bfloat16, KernelConfig(block_tokens=16, block_slots=8)),
        # L/16's width: two 768-column chunks
        ("L/16 layer d1024 bf16", 8, 196, 1024, 128, torch.bfloat16, None),
        # several token chunks with a ragged last one (300 = 4 x 64 + 44),
        # two slot tiles with a ragged last one (150 = 128 + 22), a ragged
        # last d-tile (264 = 8 x 32 + 8)
        ("chunks m300 d264 S150 f32", 2, 300, 264, 150, torch.float32,
         None),
        # granite-moe-1b-a400m+soft's layer at seq 2048
        ("granite layer bf16", 8, 2048, 1024, 32, torch.bfloat16, None),
    ]

    def check(got, want, dt):
        diff = (got.float() - want.float()).abs()
        top = want.float().abs().max()
        rel = (diff.max() / top).item()
        if got.dtype == torch.float32 or dt == torch.float32:
            return diff.max().item(), rel, rel <= 1e-5
        ok = bool((diff <= 2.0**-7 * want.float().abs() + 1e-5 * top).all())
        return diff.max().item(), rel, ok

    # the main kernels' dynamic shared memory a CTA (ptxas prints their
    # registers and spills in the build phase)
    import ctypes

    from repro_torch.kernels.build import load
    for lib in ("soft_moe_dispatch_bwd", "soft_moe_combine_bwd"):
        fn = getattr(load(lib), f"{lib}_smem_bytes")
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        log(f"[softmoe-bwd] {lib} shared memory a CTA: " + ", ".join(
            f"{dn} S={s}: {fn(code, s)} B" for dn, code in (("bf16", 1),
                                                           ("f32", 0))
            for s in (32, 64, 128)))

    main, granite = {}, None
    for i, (label, b, m, d, s, dt, kcfg) in enumerate(cases):
        c = bwd_case(torch, 300 + i, b, m, d, s, dt, kcfg)
        if label.startswith("granite"):
            granite = c
        args4 = (c["x"], c["phi_n"], c["g_slots"], c["d_stats"], c["slots"])
        args5 = (c["x"], c["phi_n"], c["ys"], c["g"], c["c_stats"], c["y"])
        dx4, dphi4 = dispatch_bwd(*args4, kcfg)
        dx5, dphi5, dys5 = combine_bwd(*args5, kcfg)
        torch.cuda.synchronize()
        r4 = dispatch_bwd_ref(*args4, kcfg)
        r5 = combine_bwd_ref(*args5, kcfg)
        errs, oks = {}, []
        for name, got, want in (("K4 dx", dx4, r4[0]), ("K4 dphi", dphi4, r4[1]),
                                ("K5 dx", dx5, r5[0]), ("K5 dphi", dphi5, r5[1]),
                                ("K5 dys", dys5, r5[2])):
            abs_err, errs[name], ok = check(got, want, dt)
            errs[name + " abs"] = abs_err
            oks.append(ok)
        outs = (dx4, dphi4, dx5, dphi5, dys5)
        finite = all(bool(torch.isfinite(t).all()) for t in outs)
        # row independence: dx and dys of each row equal a batch-1 call
        # bitwise; dPhi_n equals the row-order sum of the batch-1 dPhi_n's
        bitwise, acc4, acc5 = True, None, None
        for r in range(b):
            sl = slice(r, r + 1)
            one4 = (c["x"][sl], c["phi_n"], c["g_slots"][sl],
                    tuple(t[sl] for t in c["d_stats"]), c["slots"][sl])
            one5 = (c["x"][sl], c["phi_n"], c["ys"][sl], c["g"][sl],
                    tuple(t[sl] for t in c["c_stats"]), c["y"][sl])
            rx4, rp4 = dispatch_bwd(*one4, kcfg)
            rx5, rp5, ry5 = combine_bwd(*one5, kcfg)
            bitwise &= (torch.equal(rx4[0], dx4[r]) and torch.equal(rx5[0], dx5[r])
                        and torch.equal(ry5[0], dys5[r]))
            acc4 = rp4 if acc4 is None else acc4 + rp4
            acc5 = rp5 if acc5 is None else acc5 + rp5
        row_sum = torch.equal(acc4, dphi4) and torch.equal(acc5, dphi5)
        again4 = dispatch_bwd(*args4, kcfg)
        again5 = combine_bwd(*args5, kcfg)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b_) for a, b_ in zip(again4 + again5, outs))
        ct = BWD_TILES * (kcfg or default_config(m, d, s)).block_tokens
        log(f"[softmoe-bwd] {label}: b={b} m={m} d={d} S={s} "
            f"{str(dt).replace('torch.', '')} chunks={-(-m // ct)} of "
            f"{ct} tokens "
            "max|diff|/max|ref|: "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items()
                       if not k.endswith("abs"))
            + f" (tol f32 1e-5 of max|ref|; bf16 one bf16 step + 1e-5 of "
            f"max|ref|: {all(oks)}); finite={finite} "
            f"batched==batch1_bitwise={bitwise} "
            f"dphi==row_order_sum_of_batch1={row_sum} "
            f"second_run_bitwise={same}")
        if not (all(oks) and finite and bitwise and row_sum and same):
            raise AssertionError(f"soft-moe backward kernels {label} failed")
        if i == 0:
            main = {"case": c,
                    "err": {"dispatch_bwd": max(errs["K4 dx abs"],
                                                errs["K4 dphi abs"]),
                            "combine_bwd": max(errs["K5 dx abs"],
                                               errs["K5 dphi abs"],
                                               errs["K5 dys abs"])}}

    # No fallback: malformed operands raise and launch nothing.
    c = main["case"]
    x, phi_n, g_slots, g = c["x"], c["phi_n"], c["g_slots"], c["g"]
    counts = lambda: (dispatch_bwd.launches, combine_bwd.launches)  # noqa: E731
    before = counts()
    for call, exc, why in (
            (lambda: dispatch_bwd(x.half(), phi_n, g_slots.half(),
                                  c["d_stats"], c["slots"]), TypeError,
             "float16 x"),
            (lambda: dispatch_bwd(x, phi_n, g_slots.float(), c["d_stats"],
                                  c["slots"]), TypeError,
             "g_slots dtype != x dtype"),
            (lambda: combine_bwd(x, phi_n, c["ys"],
                                 g.transpose(1, 2).contiguous()
                                 .transpose(1, 2), c["c_stats"], c["y"]),
             ValueError, "non-contiguous g"),
            (lambda: combine_bwd(x, phi_n, c["ys"], g,
                                 (c["c_stats"][0][:, :5], c["c_stats"][1]),
                                 c["y"]), ValueError,
             "stats of the wrong shape"),
            (lambda: dispatch_bwd(x, phi_n, g_slots, c["d_stats"], c["slots"],
                                  KernelConfig(block_slots=64)), ValueError,
             "block_slots=64 > 32"),
            (lambda: combine_bwd(x, phi_n, c["ys"], g.clone()
                                 .requires_grad_(), c["c_stats"], c["y"]),
             NotImplementedError, "g requires grad (a raw kernel has no "
             "backward)")):
        try:
            call()
        except exc as e:
            log(f"[softmoe-bwd] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if counts() != before:
        raise AssertionError("a malformed call launched a kernel")

    # Times at the B/16 layer's shapes (b=64, m=196, d=768, S=128, bf16),
    # then at the granite layer's (b=8, m=2048, d=1024, S=32, bf16), each
    # beside its bound, its plain version, the SDPA backward and the
    # einsum path's backward.
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    out = {}
    for c, shape in ((c, "b=64 m=196 d=768 S=128 bf16"),
                     (granite, "b=8 m=2048 d=1024 S=32 bf16")):
        args4 = (c["x"], c["phi_n"], c["g_slots"], c["d_stats"], c["slots"])
        args5 = (c["x"], c["phi_n"], c["ys"], c["g"], c["c_stats"], c["y"])
        calls = {
            "dispatch_bwd": (lambda a=args4: dispatch_bwd(*a),
                             lambda a=args4: dispatch_bwd_ref(*a), "dispatch"),
            "combine_bwd": (lambda a=args5: combine_bwd(*a),
                            lambda a=args5: combine_bwd_ref(*a), "combine"),
        }
        library, einsum = softmoe_bwd_yardsticks(torch, c, flush, shape)
        for name, (kern, plain, kind) in calls.items():
            kernel_ms = time_ms(torch, kern, flush=flush)
            plain_ms = time_ms(torch, plain, reps=3, flush=flush)
            einsum_ms = time_ms(torch, einsum[kind], flush=flush)
            label, library_ms = min(library[kind][0].items(),
                                    key=lambda r: r[1])
            bound_ms, bound_by, nbytes, flops = soft_moe_bwd_bounds(
                c["x"], c["phi_n"].shape[1], kind)
            design_ms, design_by, d_bytes, d_ops = soft_moe_bwd_design_bound(
                c["x"], c["phi_n"].shape[1], kind)
            log(f"[softmoe-bwd] {name} timing ({shape}, L2 flushed): "
                f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} (scaled_dot_product_attention "
                f"backward, {label}) einsum_path_bwd_ms={einsum_ms:.4f} "
                f"bound={bound_ms * 1e3:.2f} us ({bound_by}: "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the f32 "
                f"rate) -> {flops / kernel_ms / 1e9:.2f} TFLOP/s of the "
                f"least work; design bound={design_ms * 1e3:.2f} us "
                f"({design_by}: {d_bytes / 1e6:.1f} MB with the chunk "
                f"partials, {d_ops * 1e6:.2f} us of tensor-core passes)")
            # device time of one call by launch: the norm pre-pass, the
            # main kernel, the partial sums and the wrapper's torch ops
            _, prof = profile_ticks(torch, types.SimpleNamespace(step=kern), 5)
            log(f"[softmoe-bwd] {name} device time of one call by kernel "
                f"({shape}): " + "; ".join(
                    f"{kname[:60]} {us / 5:.1f} us x{n // 5}"
                    for kname, us, n in prof))
            row = {"ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "einsum_path_ms": einsum_ms,
                   "design_bound_ms": design_ms}
            if c is granite:
                out[name]["granite"] = row
            else:
                out[name] = {"max_abs_err": main["err"][name], **row}
    return out


def softmoe_bwd_yardsticks(torch, c, flush, shape):
    """The yardsticks of K4 and K5 on the operands of case ``c``:
    ({kind: sdpa_bwd_options(...)}, {kind: the einsum path's backward}) for
    kind "dispatch" and "combine"; logs each backend's time and why the
    others refused.

    The library yardstick: the backward alone of the
    scaled_dot_product_attention call that computes each forward
    (dispatch: q = Phi_n^T, k = l2norm(x), v = x; combine: q = l2norm(x),
    k = Phi_n^T, v = Ys; scale 1; Phi_n in x's dtype), as
    torch.autograd.grad over a retained graph given the same output
    gradient; the forward runs outside the timed window. The einsum path
    is the port's unfused path of the same functions (use_kernel=False in
    core/soft_moe.py), its backward alone over a retained graph."""
    from repro_torch.core.soft_moe import soft_moe_weights

    x, phi_n, g_slots, g, ys = (c[k] for k in ("x", "phi_n", "g_slots", "g",
                                               "ys"))
    b, m, d = x.shape
    s = phi_n.shape[1]
    xf = x.float()
    xn = (xf / (xf.norm(dim=-1, keepdim=True) + 1e-6)).to(x.dtype)
    phi_t = phi_n.t().contiguous().to(x.dtype)[None, None]
    layouts = {"broadcast": lambda t: t.expand(b, 1, s, d),
               "copied": lambda t: t.expand(b, 1, s, d).contiguous()}
    library = {
        "dispatch": sdpa_bwd_options(
            torch, {k: (f(phi_t), xn[:, None], x[:, None])
                    for k, f in layouts.items()}, g_slots[:, None], flush),
        "combine": sdpa_bwd_options(
            torch, {k: (xn[:, None], f(phi_t), ys[:, None])
                    for k, f in layouts.items()}, g[:, None], flush),
    }
    for kind, (runs, refused) in library.items():
        log(f"[softmoe-bwd] sdpa backward for {kind} ({shape}): runs: "
            + "; ".join(f"{k} {ms:.4f} ms" for k, ms in runs.items())
            + "; refused: "
            + "; ".join(f"{k}: {why}" for k, why in refused.items()))

    def einsum_bwd(kind):
        xe = x.detach().requires_grad_()
        phie = phi_n.reshape(d, s, 1).detach().requires_grad_()
        one = torch.ones((), device="cuda")
        if kind == "dispatch":
            d_w, _ = soft_moe_weights(xe, phie, one)
            out = torch.einsum("bmd,bmnp->bnpd", xe.float(), d_w).to(x.dtype)
            grad, wrt = g_slots.reshape(b, s, 1, d), (xe, phie)
        else:
            yse = ys.detach().requires_grad_()
            _, c_w = soft_moe_weights(xe, phie, one)
            out = torch.einsum("bnpd,bmnp->bmd",
                               yse.float().reshape(b, s, 1, d),
                               c_w).to(x.dtype)
            grad, wrt = g, (xe, phie, yse)
        return lambda: torch.autograd.grad(out, wrt, grad, retain_graph=True)

    return library, {k: einsum_bwd(k) for k in ("dispatch", "combine")}


def sdpa_bwd_options(torch, operands, grad_out, flush):
    """Time the backward of one scaled_dot_product_attention call (scale
    1) on each operand layout in ``operands`` ({layout: (q, k, v)}) under
    each backend that takes it: the forward builds a graph from leaf
    copies of the operands, and the timed call is ``torch.autograd.grad``
    of its output given ``grad_out``, over the retained graph. Returns
    ({"BACKEND, layout": ms}, {"BACKEND, layout": why it refused})."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    runs, refused = {}, {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for layout, qkv in operands.items():
            key = f"{be.name}, {layout}"
            leaves = [t.detach().requires_grad_() for t in qkv]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    with sdpa_kernel([be]):
                        out = sdpa(*leaves, scale=1.0)

                    def bwd(out=out, leaves=leaves):
                        return torch.autograd.grad(out, leaves, grad_out,
                                                   retain_graph=True)

                    bwd()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    why = [str(w.message).split(" (Triggered internally")[0]
                           for w in caught]
                    why = [w for w in why if not w.endswith("because:")]
                    refused[key] = " | ".join(why or [str(e)])[:400]
                    continue
            runs[key] = time_ms(torch, bwd, flush=flush)
            del out
    return runs, refused


# ---------------------------------------------------------------------------
# phase 6: the routing-health kernel K6 against its plain version
# ---------------------------------------------------------------------------


def health_bounds(x, s):
    """Least time on the card for one K6 call: the bytes of x, Phi_n, the
    four stats in and the four outputs over HBM bandwidth vs the f32 flops
    of the logits (2 m S d a row) and the norms (2 m d) over the f32 rate;
    the O(m S) weights and their sums are not counted."""
    b, m, d = x.shape
    nbytes = (b * m * d * x.element_size() + d * s * 4
              + 2 * (2 * b * s * 4 + 2 * b * m * 4))
    flops = b * (2 * m * s * d + 2 * m * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_routing_health(torch):
    from repro_torch.core.inspection import routing_health_from_stats
    from repro_torch.core.soft_moe import (
        _dense_routing_health,
        soft_moe_weights,
    )
    from repro_torch.kernels.soft_moe_kernels import (
        routing_fwd,
        routing_health,
        routing_health_ref,
    )
    from repro_torch.kernels.tuning import KernelConfig

    # Elementwise |out - ref| <= atol + rtol |ref|, all f32: against the
    # plain version 1e-5 + 1e-4 |ref| (sums of up to 2048 terms taken in
    # other orders, logits dotted over d in another order); against the
    # chunked oracle, which normalizes x before the dot, 1e-4 + 1e-4 |ref|.
    tol, oracle_tol = (1e-5, 1e-4), (1e-4, 1e-4)
    names = ("disp_entropy", "importance", "comb_entropy", "token_contrib")
    cases = [
        # (label, b, m, d, S, dtype, cfg)
        ("granite layer bf16", 8, 2048, 1024, 32, torch.bfloat16, None),
        ("granite layer f32", 8, 2048, 1024, 32, torch.float32, None),
        ("B/16 layer bf16", 64, 196, 768, 128, torch.bfloat16, None),
        ("B/16 layer f32", 64, 196, 768, 128, torch.float32, None),
        # a ragged last token block (45 = 32 + 13) and slot block
        # (40 = 32 + 8), several slot blocks
        ("ragged m45 d264 S40 f32", 3, 45, 264, 40, torch.float32, None),
        ("ragged m45 d264 S40 bf16 bt16 bs8", 3, 45, 264, 40,
         torch.bfloat16, KernelConfig(block_tokens=16, block_slots=8)),
    ]
    main = {}
    for i, (label, b, m, d, s, dt, kcfg) in enumerate(cases):
        x, phi_n, _ = soft_moe_case(torch, 600 + i, b, m, d, s, dt)
        with torch.no_grad():
            _, d_stats, c_stats = routing_fwd(x, phi_n, kcfg)
        got = routing_health(x, phi_n, d_stats, c_stats, kcfg)
        torch.cuda.synchronize()
        want = routing_health_ref(x, phi_n, d_stats, c_stats, kcfg)
        # the oracle normalizes x in its dtype: hand it the same values in
        # f32, as the kernel normalizes them
        oracle = routing_health_from_stats(x.float(), phi_n, d_stats,
                                           c_stats)
        errs, oks = {}, []
        for n, g, w, o in zip(names, got, want, oracle):
            errs[n], ok = within(torch, g, w, *tol)
            errs[n + " vs oracle"], ok2 = within(torch, g, o, *oracle_tol)
            oks += [ok, ok2]
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        bitwise = True
        for r in sorted({0, min(1, b - 1), b - 1}):
            one = routing_health(x[r:r + 1], phi_n,
                                 tuple(t[r:r + 1] for t in d_stats),
                                 tuple(t[r:r + 1] for t in c_stats), kcfg)
            bitwise &= all(torch.equal(a[0], g[r]) for a, g in zip(one, got))
        again = routing_health(x, phi_n, d_stats, c_stats, kcfg)
        torch.cuda.synchronize()
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        log(f"[health] {label}: b={b} m={m} d={d} S={s} "
            f"{str(dt).replace('torch.', '')} max_abs_err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f" (tol plain {tol[0]:.0e} + {tol[1]:.0e}|ref|, oracle "
            f"{oracle_tol[0]:.0e} + {oracle_tol[1]:.0e}|ref|: {all(oks)}); "
            f"finite={finite} batched==batch1_bitwise={bitwise} "
            f"second_run_bitwise={same}")
        if not (all(oks) and finite and bitwise and same):
            raise AssertionError(f"routing_health {label} failed")
        if i == 0:
            main = {"args": (x, phi_n, d_stats, c_stats),
                    "err": max(errs[n] for n in names)}

    # No fallback: malformed operands raise and launch nothing.
    x, phi_n, d_stats, c_stats = main["args"]
    before = routing_health.launches
    for call, exc, why in (
            (lambda: routing_health(x.half(), phi_n, d_stats, c_stats),
             TypeError, "float16 x"),
            (lambda: routing_health(x, phi_n, (d_stats[0].double(),
                                               d_stats[1]), c_stats),
             TypeError, "float64 d_mx"),
            (lambda: routing_health(x.transpose(1, 2).contiguous()
                                    .transpose(1, 2), phi_n, d_stats,
                                    c_stats), ValueError, "non-contiguous x"),
            (lambda: routing_health(x, phi_n, d_stats,
                                    (c_stats[0][:, :5], c_stats[1])),
             ValueError, "stats of the wrong shape"),
            (lambda: routing_health(x, phi_n, d_stats, c_stats,
                                    KernelConfig(block_slots=64)),
             ValueError, "block_slots=64 > 32"),
            (lambda: routing_health(x.clone().requires_grad_(), phi_n,
                                    d_stats, c_stats),
             NotImplementedError, "x requires grad (telemetry has no "
             "backward)")):
        try:
            call()
        except exc as e:
            log(f"[health] malformed operands ({why}) raise "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"malformed operands ({why}) did not raise")
    if routing_health.launches != before:
        raise AssertionError("a malformed call launched the kernel")

    # Times at the granite layer's shapes (b=8, m=2048, d=1024, S=32,
    # bf16). No single PyTorch call computes these four reductions; the
    # yardstick is the port's einsum path on the same operands
    # (soft_moe_weights, then _dense_routing_health).
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    b, m, d = x.shape
    s = phi_n.shape[1]
    phi3, one = phi_n.reshape(d, s, 1), torch.ones((), device="cuda")

    def einsum_path():
        return _dense_routing_health(*soft_moe_weights(x, phi3, one))

    kernel_ms = time_ms(torch, lambda: routing_health(x, phi_n, d_stats,
                                                      c_stats), flush=flush)
    plain_ms = time_ms(torch, lambda: routing_health_ref(x, phi_n, d_stats,
                                                         c_stats),
                       reps=3, flush=flush)
    einsum_ms = time_ms(torch, einsum_path, flush=flush)
    bound_ms, bound_by, nbytes, flops = health_bounds(x, s)
    log(f"[health] routing_health timing (b={b} m={m} d={d} S={s} bf16, L2 "
        f"flushed): kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms=null (no single library call) "
        f"einsum_path_ms={einsum_ms:.4f} (soft_moe_weights + "
        f"_dense_routing_health) bound={bound_ms * 1e3:.2f} us ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) -> "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s")
    return {"routing_health": {
        "max_abs_err": main["err"], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "einsum_path_ms": einsum_ms}}


# ---------------------------------------------------------------------------
# phase 7: serve full-width qwen2-0.5b
# ---------------------------------------------------------------------------


def make_requests(np, vocab, seed=0):
    """16 prompts of 16..1024 tokens; requests 0 and 12 share a 256-token
    prefix (12 is admitted long after 0 has published it)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(16, 1025, size=16)
    lens[0], lens[12] = max(lens[0], 300), max(lens[12], 300)
    prefix = rng.randint(1, vocab, size=256).tolist()
    prompts = []
    for i, n in enumerate(lens):
        tail = rng.randint(1, vocab, size=int(n)).tolist()
        prompts.append(prefix + tail[: n - 256] if i in (0, 12) else tail)
    return prompts


def timed_decode(torch, eng):
    """Wrap ``eng``'s decode program so each call's synchronised host time
    lands in the returned list."""
    decode_s = []
    inner = eng.backend.decode

    def decode(*a):
        t0 = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        return out

    eng.backend.decode = decode
    return decode_s


def run_engine(torch, eng, prompts, max_new):
    """Drive ``eng`` over ``prompts``; returns the requests, the wall
    seconds and the decode-step times."""
    from repro_torch.serve import Request

    decode_s = timed_decode(torch, eng)
    reqs = [Request(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, decode_s


def teacher_forced(torch, eng, oracle, prompts, max_new):
    """Run ``eng`` (kernel) and ``oracle`` (gather) tick by tick over the
    same requests. Before each sampling pass the oracle's logits of every
    decoding row are held against the engine's, then replaced by them, so
    both engines sample the same tokens and keep the same schedule: every
    live row is compared at every tick, late in each request too.

    Returns per-tick (slots, max abs diff, greedy tokens that agree)."""
    from repro_torch.serve import Request

    snap = {}
    ticks = []
    eng_decode, oracle_decode = eng._do_decode, oracle._do_decode

    def eng_sample():
        snap["slots"] = sorted(e.slot for e in eng.sched.decode_entries())
        snap["logits"] = eng._logits.clone()
        return eng_decode()

    def oracle_sample():
        slots = sorted(e.slot for e in oracle.sched.decode_entries())
        if slots != snap["slots"]:
            raise AssertionError(f"schedules diverged: kernel engine decodes "
                                 f"{snap['slots']}, gather engine {slots}")
        if slots:
            mine, ref = snap["logits"][slots], oracle._logits[slots]
            agree = int((mine.argmax(-1) == ref.argmax(-1)).sum())
            ticks.append((slots, (mine - ref).abs().max().item(), agree))
        oracle._logits = snap["logits"]
        return oracle_decode()

    eng._do_decode, oracle._do_decode = eng_sample, oracle_sample
    for e in (eng, oracle):
        for p in prompts:
            e.submit(Request(prompt=list(p), max_new_tokens=max_new))
    while eng.sched.pending() or oracle.sched.pending():
        snap.clear()
        eng.step()
        oracle.step()
    return ticks


def profile_ticks(torch, eng, n):
    """Trace ``n`` engine ticks with torch.profiler; returns the window's
    wall seconds and (kernel name, device us, launches) rows, largest
    first. Kernels run on one stream, so their summed time over the wall
    time is the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, cnt = per.get(ev.name, (0.0, 0))
            per[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((k, us, c) for k, (us, c) in per.items()),
                  key=lambda r: -r[1])
    return wall, rows


def kernel_kind(name):
    """The profile's kernel groups: the port's kernels, cuBLAS matmuls
    (``nvjet`` is cuBLAS's own kernel family), copies and dtype casts,
    and everything else."""
    low = name.lower()
    if "health_kernel" in name or "health_merge_kernel" in name:
        return "K6 routing health"
    if "paged_decode_kernel" in name:
        return "K7 paged decode attention"
    if "dispatch_bwd" in name:
        return "K4 dispatch backward"
    if "combine_bwd" in name:
        return "K5 combine backward"
    if any(k in name for k in ("prepass_kernel", "dphi_reduce_kernel",
                               "chunk_sum_kernel")):
        return "K4/K5 pre-pass and partial sums"
    if "routing_kernel" in name or "merge_kernel" in name:
        return "K1 routing"
    if "combine_kernel" in name:
        return "K2/K3 combine"
    if "inv_norm_kernel" in name:
        return "K1/K2/K6 norm pre-pass"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "matmul"
    if "copy_kernel" in low:
        return "copies and dtype casts"
    return "other"


def phase_serve(torch, card):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.models import lm_init
    from repro_torch.optim import tree_leaves
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"ff={cfg.d_ff} heads {cfg.attention.num_heads}/"
        f"{cfg.attention.num_kv_heads} vocab {cfg.vocab_size}, "
        f"{n_params / 1e6:.1f} M params (init "
        f"{time.perf_counter() - t0:.1f} s)")
    geo = dict(batch_size=8, max_len=2048, block_size=16, device="cuda")
    prompts = make_requests(np, cfg.vocab_size)
    max_new = 32

    # warm-up on a throwaway engine: allocator, cuBLAS handles
    warm = ServeEngine(cfg, params, **geo)
    run_engine(torch, warm, prompts[1:3], 4)
    del warm

    eng = ServeEngine(cfg, params, **geo)
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attend.launches = 0
    reqs, wall, decode_s = run_engine(torch, eng, prompts, max_new)
    launches = paged_decode_attend.launches
    done = all(r.done and r.finish_reason == "length" for r in reqs)
    hits = eng.backend.prefix.hits
    log(f"[serve] kernel engine: {len(reqs)} requests done={done}, "
        f"{eng.decode_steps} decode steps, {eng.ticks} ticks, "
        f"{eng.preemptions} preemptions, radix block hits={hits}, "
        f"kernel launches={launches} (decode_steps x {cfg.num_layers} = "
        f"{eng.decode_steps * cfg.num_layers})")
    if not done:
        raise AssertionError("not every request finished with 'length'")
    if hits < 1:
        raise AssertionError("the radix prefix cache recorded no block hit")
    if launches != eng.decode_steps * cfg.num_layers or launches == 0:
        raise AssertionError("kernel launches != decode_steps x layers")
    for r in reqs:
        out = np.asarray(r.out)
        if len(out) != max_new or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError("a request produced out-of-range tokens")
    n_tok = sum(len(r.out) for r in reqs)
    ttft = statistics.median(r.t_first_token - r.t_submit for r in reqs)
    step_ms = statistics.median(decode_s) * 1e3
    peak_alloc = torch.cuda.max_memory_allocated()
    log(f"[serve] {card}: {n_tok / wall:.1f} tok/s ({n_tok} tokens in "
        f"{wall:.2f} s), p50 TTFT {ttft * 1e3:.1f} ms, decode step "
        f"p50 {step_ms:.2f} ms (mean {1e3 * sum(decode_s) / len(decode_s):.2f}"
        f" ms), peak cache bytes {eng.peak_cache_bytes()} "
        f"(pool {eng.backend.bytes_per_block() * eng.backend.num_blocks}), "
        f"peak device memory {peak_alloc / 2**30:.2f} GiB")

    # Where the time goes: trace 10 ticks in the middle of the same trace
    # (prefill chunk + decode step each) on a fresh kernel engine.
    prof_eng = ServeEngine(cfg, params, **geo)
    for p in prompts:
        prof_eng.submit(Request(prompt=list(p), max_new_tokens=max_new))
    for _ in range(60):
        prof_eng.step()
    pwall, prows = profile_ticks(torch, prof_eng, 10)
    busy = sum(us for _, us, _ in prows) / 1e6
    log(f"[profile] {card}: 10 ticks (ticks 61-70 of the trace) in "
        f"{pwall * 1e3:.1f} ms wall under the profiler; device busy "
        f"{busy * 1e3:.1f} ms = {busy / pwall:.3f} of wall")
    kinds = {}
    for name, us, cnt in prows:
        k = kernel_kind(name)
        kinds[k] = (kinds.get(k, (0.0, 0))[0] + us,
                    kinds.get(k, (0.0, 0))[1] + cnt)
    for k, (us, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        log(f"[profile]   {k}: {us / 1e3:.2f} ms in {cnt} launches "
            f"({us / 1e6 / pwall:.3f} of wall)")
    for name, us, cnt in prows[:8]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{cnt} {name[:90]}")
    del prof_eng

    # Kernel engine against the gather engine (use_kernel=False), teacher
    # forced: the serving trace above, then a burst of 8 short prompts
    # that keeps all 8 slots decoding at once.
    rng = np.random.RandomState(1)
    burst = [rng.randint(1, cfg.vocab_size, size=n).tolist()
             for n in range(16, 48, 4)]
    ticks = []
    odecode_s = []
    for trace, n_new in ((prompts, max_new), (burst, 48)):
        oracle = ServeEngine(cfg, params, use_kernel=False, **geo)
        times = timed_decode(torch, oracle)
        ticks += teacher_forced(torch, ServeEngine(cfg, params, **geo),
                                oracle, trace, n_new)
        odecode_s += times
        del oracle
    diffs = [d for _, d, _ in ticks]
    rows = sum(len(sl) for sl, _, _ in ticks)
    agree = sum(a for _, _, a in ticks)
    full = sum(len(sl) == geo["batch_size"] for sl, _, _ in ticks)
    slots_seen = sorted({x for sl, _, _ in ticks for x in sl})
    worst = max(range(len(ticks)), key=lambda i: diffs[i])
    log(f"[serve] gather engine (use_kernel=False): decode step p50 "
        f"{statistics.median(odecode_s) * 1e3:.2f} ms")
    log(f"[serve] kernel vs gather engine, teacher forced: {len(ticks)} "
        f"sampling passes, {rows} row logits compared (slots {slots_seen}; "
        f"{full} passes with all {geo['batch_size']} slots decoding); "
        f"first passes max_abs_diff "
        f"{', '.join(f'{d:.3e}' for d in diffs[:3])}; "
        f"all passes max_abs_diff={diffs[worst]:.3e} at pass {worst} "
        f"(rows {ticks[worst][0]}), median of the passes' max "
        f"{statistics.median(diffs):.3e} (tol 5e-2); identical greedy "
        f"tokens {agree}/{rows} = {agree / rows:.4f}")
    if not all(math.isfinite(d) for d in diffs) or max(diffs) > 5e-2:
        raise AssertionError("kernel engine logits disagree with the gather "
                             "engine")
    if full == 0 or len(slots_seen) != geo["batch_size"]:
        raise AssertionError("the comparison never had every slot decoding")
    return {"paged_decode_attend": launches}


# ---------------------------------------------------------------------------
# phase 8: Soft-MoE ViT-B/16 inference at full width and depth
# ---------------------------------------------------------------------------


def rel_err(torch, got, want):
    """max |got - want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_vit(torch, card):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import soft_moe_apply
    from repro_torch.kernels import ops
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_online,
        routing_fwd,
    )
    from repro_torch.kernels.tuning import config_from_moe
    from repro_torch.layers.mlp import experts_apply
    from repro_torch.models import lm, vit_apply, vit_features, vit_init
    from repro_torch.optim import tree_leaves

    cfg = get_config("soft-moe-b/16-128e")
    n_moe = len(cfg.moe_layer_indices())
    t0 = time.perf_counter()
    params = vit_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[vit] {cfg.name}: {cfg.num_layers} layers ({n_moe} Soft-MoE, "
        f"{cfg.moe.num_experts} experts x {cfg.moe.slots_per_expert} slot) "
        f"d={cfg.d_model} ff={cfg.d_ff} heads {cfg.attention.num_heads}, "
        f"{n_params / 1e9:.3f} B params in f32 (init "
        f"{time.perf_counter() - t0:.1f} s), compute {cfg.dtype}")
    batch, tokens, patch_dim = 64, cfg.frontend.num_embeds, \
        cfg.frontend.embed_dim
    # N(0, 1) patches, as data/pipeline.py::SyntheticImages draws them
    patches = torch.randn(batch, tokens, patch_dim, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(1))
    counts = lambda: (routing_fwd.launches, combine_apply.launches,  # noqa: E731
                      combine_online.launches)
    with torch.inference_mode():
        for k in (True, False):  # warm-up: allocator, cuBLAS, kernels built
            vit_features(params, cfg, patches, use_kernel=k)
        torch.cuda.synchronize()

        # the main path: counts from 0, then n forwards on the kernel path
        n_fwd = 10
        routing_fwd.launches = combine_apply.launches = 0
        combine_online.launches = 0
        times = {True: [], False: []}
        peak = {}
        for k in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(n_fwd):
                t0 = time.perf_counter()
                logits, aux = vit_apply(params, cfg, patches, use_kernel=k)
                torch.cuda.synchronize()
                times[k].append(time.perf_counter() - t0)
            peak[k] = torch.cuda.max_memory_allocated()
            if k:
                launches = counts()
        log(f"[vit] launches over {n_fwd} kernel-path forwards: K1 "
            f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]} (expected "
            f"{n_moe * n_fwd}, {n_moe * n_fwd}, 0); the einsum-path "
            f"forwards added {counts()[0] - launches[0]} K1 launches")
        if launches != (n_moe * n_fwd, n_moe * n_fwd, 0) or \
                counts() != launches:
            raise AssertionError("ViT kernel launches do not match 6 x "
                                 "forwards for K1 and K2, 0 for K3")
        if logits.shape != (batch, 1000) or not bool(
                torch.isfinite(logits).all()) or float(aux) != 0.0:
            raise AssertionError("ViT logits are not finite (64, 1000)")
        p50 = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        log(f"[vit] {card}: batch {batch} x {tokens} patches: kernel path "
            f"forward p50 {p50[True]:.2f} ms = {batch / p50[True] * 1e3:.1f}"
            f" images/s; einsum path p50 {p50[False]:.2f} ms = "
            f"{batch / p50[False] * 1e3:.1f} images/s; peak device memory "
            f"kernel path {peak[True] / 2**30:.3f} GiB, einsum path "
            f"{peak[False] / 2**30:.3f} GiB (params "
            f"{n_params * 4 / 2**30:.2f} GiB)")

        # kernel path vs einsum path: pre-head features (bf16 and f32);
        # the kernel-path forward also hands over every MoE layer's input
        # (block_apply's call of moe_apply), so the layer check below runs
        # on what the model feeds the first MoE layer
        seen = []
        inner = lm.moe_apply

        def capture(p, moe_cfg, xn, *a, **kw):
            seen.append((p, moe_cfg, xn))
            return inner(p, moe_cfg, xn, *a, **kw)

        lm.moe_apply = capture
        try:
            f1 = vit_features(params, cfg, patches, use_kernel=True)
        finally:
            lm.moe_apply = inner
        if len(seen) != n_moe:
            raise AssertionError(f"{len(seen)} MoE calls in a forward, "
                                 f"expected {n_moe}")
        f0 = vit_features(params, cfg, patches, use_kernel=False)
        bf16_err = rel_err(torch, f1, f0)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        f1_32 = vit_features(params, cfg32, patches, use_kernel=True)
        f0_32 = vit_features(params, cfg32, patches, use_kernel=False)
        f32_err = rel_err(torch, f1_32, f0_32)

        # one MoE layer (the first) on the input the forward gave it
        first = cfg.moe_layer_indices()[0]
        moe_params, moe_cfg, xn = seen[0]
        seen.clear()
        y1, m1 = soft_moe_apply(moe_params, moe_cfg, xn, cfg.act,
                                use_kernel=True)
        y0, m0 = soft_moe_apply(moe_params, moe_cfg, xn, cfg.act,
                                use_kernel=False)
        layer_err = rel_err(torch, y1, y0)
        xn32 = xn.float()
        y1_32, _ = soft_moe_apply(moe_params, moe_cfg, xn32, cfg.act,
                                  use_kernel=True)
        y0_32, _ = soft_moe_apply(moe_params, moe_cfg, xn32, cfg.act,
                                  use_kernel=False)
        layer_err32 = rel_err(torch, y1_32, y0_32)

        # K3's path: the ops-level combine without saved stats, on the
        # same layer; counts from 0
        routing_fwd.launches = combine_apply.launches = 0
        combine_online.launches = 0
        kcfg = config_from_moe(moe_cfg, xn.shape[1], xn.shape[2])
        phi_n = ops.normalized_phi(moe_params["phi"], moe_params["scale"])
        slots, _ = ops.soft_moe_routing(xn, phi_n, kcfg)
        n, d = moe_cfg.num_experts, cfg.d_model
        ys = experts_apply(moe_params["experts"],
                           slots.transpose(0, 1).contiguous(), cfg.act)
        y3 = ops.soft_moe_combine(xn, phi_n, ys.transpose(0, 1).contiguous(),
                                  c_stats=None, config=kcfg)
        k3_launches = counts()
        torch.cuda.synchronize()
        k3_err, k3_ok = within(torch, y3, y1, 1e-5, 2.0**-7)
    log(f"[vit] kernel vs einsum path, max|diff|/max|ref|: features bf16 "
        f"{bf16_err:.3e} (tol 5e-2), features f32 {f32_err:.3e} (tol "
        f"1e-4); first MoE layer (layer {first}) bf16 {layer_err:.3e} (tol "
        f"2e-2), f32 {layer_err32:.3e} (tol 1e-4); max_combine kernel "
        f"{float(m1['max_combine']):.6f} einsum "
        f"{float(m0['max_combine']):.6f}")
    log(f"[vit] K3 path (ops.soft_moe_combine without stats) on layer "
        f"{first}: launches K1 {k3_launches[0]} K2 {k3_launches[1]} K3 "
        f"{k3_launches[2]}; vs the layer's K2 path max_abs_err "
        f"{k3_err:.3e} (one bf16 step: {k3_ok})")
    if not (bf16_err <= 5e-2 and f32_err <= 1e-4 and layer_err <= 2e-2
            and layer_err32 <= 1e-4):
        raise AssertionError("the ViT kernel path disagrees with the einsum "
                             "path")
    if k3_launches != (1, 0, 1) or not k3_ok:
        raise AssertionError("the K3 combine path failed")

    # Where the time goes: 3 kernel-path forwards under the profiler
    with torch.inference_mode():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                vit_apply(params, cfg, patches, use_kernel=True)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, cnt = per.get(ev.name, (0.0, 0))
            per[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((k, us, c) for k, (us, c) in per.items()),
                  key=lambda r: -r[1])
    busy = sum(us for _, us, _ in rows) / 1e6
    log(f"[profile] vit {card}: 3 kernel-path forwards in "
        f"{pwall * 1e3:.1f} ms wall under the profiler; device busy "
        f"{busy * 1e3:.1f} ms = {busy / pwall:.3f} of wall")
    kinds = {}
    for name, us, cnt in rows:
        k = kernel_kind(name)
        kinds[k] = (kinds.get(k, (0.0, 0))[0] + us,
                    kinds.get(k, (0.0, 0))[1] + cnt)
    for k, (us, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        log(f"[profile]   {k}: {us / 1e3:.2f} ms in {cnt} launches "
            f"({us / 1e6 / busy:.3f} of device time)")
    for name, us, cnt in rows[:10]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{cnt} {name[:90]}")
    return {"routing_fwd": launches[0], "combine_apply": launches[1],
            "combine_online": k3_launches[2]}


# ---------------------------------------------------------------------------
# phase 9: Soft-MoE ViT-B/16 training steps at full width and depth
# ---------------------------------------------------------------------------


def phase_train(torch, card):
    import dataclasses
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import soft_moe_apply
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
    )
    from repro_torch.models import lm, vit_init, vit_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves, tree_map
    from repro_torch.train import init_train_state, make_train_step

    kernels = (routing_fwd, combine_apply, combine_online, dispatch_bwd,
               combine_bwd)

    def counts():
        return tuple(k.launches for k in kernels)

    def zero_counts():
        for k in kernels:
            k.launches = 0

    # earlier phases leave reference cycles (engines whose methods the
    # teacher-forced check patched) that hold device memory until collected
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("soft-moe-b/16-128e")
    n_moe = len(cfg.moe_layer_indices())
    batch = 64
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: vit_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    data = SyntheticImages(num_patches=cfg.frontend.num_embeds,
                           patch_dim=cfg.frontend.embed_dim,
                           batch_size=batch, num_classes=1000, device="cuda")
    # examples/train_vit_softmoe.py's optimizer, at its default 300 steps
    ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=20, schedule="rsqrt",
                           timescale=100.0, total_steps=300,
                           cooldown_steps=30)
    step_fn = make_train_step(
        lambda p, b: vit_loss(p, cfg, b, use_kernel=True), ocfg)
    log(f"[train] {cfg.name}: {cfg.num_layers} layers ({n_moe} Soft-MoE), "
        f"remat={cfg.remat}, {n_params / 1e9:.3f} B params; f32 params, "
        f"AdamW mu and nu (init {time.perf_counter() - t0:.1f} s), "
        f"compute {cfg.dtype}, batch {batch}")

    # step 0: the head starts at zero, so the loss is ln(1000)
    zero_counts()
    state, m0 = step_fn(state, data.batch(0))
    loss0 = float(m0["total_loss"])
    per_step = counts()
    want = (2 * n_moe, 2 * n_moe, 0, n_moe, n_moe)
    log(f"[train] step 0: loss {loss0:.6f} (ln 1000 = {math.log(1000):.6f}, "
        f"tol 1e-3); grad_norm {float(m0['grad_norm']):.4f} lr "
        f"{float(m0['lr']):.3e}; launches K1 {per_step[0]} K2 {per_step[1]} "
        f"K3 {per_step[2]} K4 {per_step[3]} K5 {per_step[4]} (expected "
        f"{want}: remat runs each MoE layer's forward twice)")
    if abs(loss0 - math.log(1000)) > 1e-3 or per_step != want:
        raise AssertionError("train step 0 failed")

    # step 1: kernel-path vs einsum-path gradients of the MoE layers' phi
    # and scale and of one expert leaf, with the head trained one step, in
    # the config's bf16 compute and in f32. Bound: 5e-2 of the leaf's
    # largest value in bf16 (PR 12's feature bound: the einsum path
    # normalizes x in bf16, the kernels in f32, so a logit moves by ~2^-9,
    # and each of the up to 12 blocks the gradient crosses adds bf16
    # roundings of up to 2^-8), 1e-4 in f32 (sums in other orders). A scale
    # gradient is one number, sum_{d,s} dPhi_n * Phi_n / scale over d S
    # terms of both signs: its error is bounded against the terms, so its
    # bound is the leaf bound times kappa = sum |terms| / |sum terms|,
    # measured from the kernel path's dPhi_n.
    from repro_torch.kernels import ops as kops

    first = cfg.moe_layer_indices()[0]
    b1 = data.batch(1)
    picks = [(f"layers[{i}].moe.{k}", ("layers", i, "moe", k))
             for i in cfg.moe_layer_indices() for k in ("phi", "scale")]
    picks.append((f"layers[{first}].moe.experts.w_up",
                  ("layers", first, "moe", "experts", "w_up")))

    def pick_grads(cfg_, use_kernel):
        wrt = tree_map(torch.Tensor.detach, state["params"])
        leaves = [_get(wrt, path) for _, path in picks]
        for t in leaves:
            t.requires_grad_()
        kappa, real = {}, kops.normalized_phi

        def spy(phi, scale):  # dPhi_n of each layer, kernel path
            out = real(phi, scale)
            if out.requires_grad:
                def hook(g, key=phi.data_ptr(), o=out.detach()):
                    t = (g.float() * o.float()).double()
                    kappa.setdefault(key, (t.abs().sum()
                                           / t.sum().abs()).item())
                out.register_hook(hook)
            return out

        kops.normalized_phi = spy
        try:
            loss, _ = vit_loss(wrt, cfg_, b1, use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            kops.normalized_phi = real
        return grads, kappa

    phi_key = {i: state["params"]["layers"][i]["moe"]["phi"].data_ptr()
               for i in cfg.moe_layer_indices()}
    grad_check = {}
    for label, cfg_, tol in (("bf16", cfg, 5e-2),
                             ("f32", dataclasses.replace(cfg,
                                                         dtype="float32"),
                              1e-4)):
        (gk, kappa), (ge, _) = pick_grads(cfg_, True), pick_grads(cfg_, False)
        rows = []
        for (name, path), a, b_ in zip(picks, gk, ge):
            err = rel_err(torch, a, b_)
            k = kappa[phi_key[path[1]]] if path[-1] == "scale" else 1.0
            rows.append((name, err, tol * k))
        del gk, ge
        grad_check[label] = rows
        log(f"[train] step 1, kernel vs einsum path gradients in {label}, "
            f"max|diff| / max|ref| (bound): "
            + " ".join(f"{n}={e:.3e} ({b_:.1e})" for n, e, b_ in rows))
    bad = [(lab, n) for lab, rows in grad_check.items()
           for n, e, b_ in rows if not e <= b_]

    # one MoE layer in f32, its input captured from the model's forward
    seen = []
    inner = lm.moe_apply

    def capture(p, moe_cfg, xn, *a, **kw):
        seen.append((p, moe_cfg, xn))
        return inner(p, moe_cfg, xn, *a, **kw)

    lm.moe_apply = capture
    try:
        with torch.no_grad():
            vit_loss(state["params"], cfg, b1, use_kernel=True)
    finally:
        lm.moe_apply = inner
    moe_params, moe_cfg, xn = seen[0]
    seen.clear()
    w = torch.randn(xn.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))

    def layer_grads(use_kernel):
        p = tree_map(torch.Tensor.detach, moe_params)
        leaves = list(tree_leaves(p))
        xin = xn.float().requires_grad_()
        for t in leaves:
            t.requires_grad_()
        y, _ = soft_moe_apply(p, moe_cfg, xin, cfg.act,
                              use_kernel=use_kernel)
        return torch.autograd.grad((y * w).sum(), leaves + [xin])

    lk, le = layer_grads(True), layer_grads(False)
    layer_err = max(rel_err(torch, a, b_) for a, b_ in zip(lk, le))
    del lk, le
    log(f"[train] step 1, layer {first} alone in f32 on its captured "
        f"input, every param and the input: kernel vs einsum path "
        f"max|diff| / max|ref| {layer_err:.3e} (tol 1e-4)")
    if bad or layer_err > 1e-4:
        raise AssertionError(f"kernel-path gradients disagree with the "
                             f"einsum path: {bad}")

    # the main path: counts from 0, then timed steps
    n_steps = 7
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for step in range(1, 1 + n_steps):
        b = data.batch(step)
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        losses.append(float(m["total_loss"]))  # host sync on the step
        times.append(time.perf_counter() - t0)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    p50 = statistics.median(times)
    log(f"[train] {card}: steps 1-{n_steps}: step p50 {p50 * 1e3:.2f} ms "
        f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) = "
        f"{batch / p50:.1f} images/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; peak device memory {peak / 2**30:.3f} GiB "
        f"(params + AdamW moments {3 * n_params * 4 / 2**30:.2f} GiB); "
        f"launches K1 {launches[0]} K2 {launches[1]} K3 {launches[2]} K4 "
        f"{launches[3]} K5 {launches[4]} (= {n_steps} x {want})")
    if launches != tuple(n_steps * c for c in want):
        raise AssertionError("train-step launches do not match 12 K1, 12 "
                             "K2, 6 K4 and 6 K5 a step")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite training loss")

    # Where the time goes: one profiled step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = data.batch(1 + n_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        float(m["total_loss"])
        pwall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, cnt = per.get(ev.name, (0.0, 0))
            per[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((k, us, c) for k, (us, c) in per.items()),
                  key=lambda r: -r[1])
    busy = sum(us for _, us, _ in rows) / 1e6
    log(f"[profile] train {card}: one step in {pwall * 1e3:.1f} ms wall "
        f"under the profiler; device busy {busy * 1e3:.1f} ms = "
        f"{busy / pwall:.3f} of wall")
    kinds = {}
    for name, us, cnt in rows:
        k = kernel_kind(name)
        kinds[k] = (kinds.get(k, (0.0, 0))[0] + us,
                    kinds.get(k, (0.0, 0))[1] + cnt)
    for k, (us, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        log(f"[profile]   {k}: {us / 1e3:.2f} ms in {cnt} launches "
            f"({us / 1e6 / busy:.3f} of device time)")
    for name, us, cnt in rows[:10]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{cnt} {name[:90]}")

    # The closing save: the train state of the first MoE layer (params,
    # AdamW moments, step), through CheckpointManager, restored bitwise
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    part = {"params": state["params"]["layers"][first],
            "opt": {"mu": state["opt"]["mu"]["layers"][first],
                    "nu": state["opt"]["nu"]["layers"][first],
                    "step": state["opt"]["step"]}}
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(part))
    mgr = CheckpointManager(str(ckpt_dir), keep=1)
    step = int(state["opt"]["step"])
    t0 = time.perf_counter()
    mgr.save(step, part, blocking=True)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = mgr.restore(mgr.latest_step(), part)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    same = all(a.dtype == b_.dtype and a.device == b_.device
               and torch.equal(a, b_)
               for a, b_ in zip(tree_leaves(back), tree_leaves(part)))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[train] checkpoint of layer {first}'s train state at step {step}: "
        f"{nbytes / 1e9:.3f} GB saved in {t_save:.2f} s "
        f"({nbytes / 1e9 / t_save:.2f} GB/s), restored in {t_restore:.2f} s "
        f"({nbytes / 1e9 / t_restore:.2f} GB/s); bitwise equal: {same}; the "
        f"whole state, {3 * n_params * 4 / 1e9:.1f} GB, would take "
        f"~{3 * n_params * 4 / (nbytes / t_save):.0f} s to save at this rate")
    if not same:
        raise AssertionError("checkpoint round trip is not bitwise")
    del state, back, part
    torch.cuda.empty_cache()
    return {"dispatch_bwd": launches[3], "combine_bwd": launches[4]}


# ---------------------------------------------------------------------------
# phase 10: Soft-MoE LM training with routing-health telemetry, granite at
# full width and depth
# ---------------------------------------------------------------------------


def phase_lm_train(torch, card):
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import soft_moe_apply
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.soft_moe_kernels import (
        combine_apply,
        combine_bwd,
        combine_online,
        dispatch_bwd,
        routing_fwd,
        routing_health,
    )
    from repro_torch.models import lm, lm_init, lm_loss
    from repro_torch.optim import OptimizerConfig, tree_leaves, tree_map
    from repro_torch.serve.telemetry import flatten_telemetry
    from repro_torch.train import (
        Trainer,
        TrainerConfig,
        init_train_state,
        make_train_step,
    )

    kernels = (routing_fwd, combine_apply, combine_online, dispatch_bwd,
               combine_bwd, routing_health)
    names = ("K1", "K2", "K3", "K4", "K5", "K6")

    def counts():
        return tuple(k.launches for k in kernels)

    def zero_counts():
        for k in kernels:
            k.launches = 0

    def show(c):
        return " ".join(f"{n} {v}" for n, v in zip(names, c))

    gc.collect()  # the earlier phases' objects, before the state
    torch.cuda.empty_cache()
    cfg = get_config("granite-moe-1b-a400m+soft")
    n_moe = len(cfg.moe_layer_indices())
    batch, seq = 8, 2048
    t0 = time.perf_counter()
    state = init_train_state(torch.Generator(device="cuda").manual_seed(0),
                             lambda g: lm_init(g, cfg))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                       batch_size=batch, seed=0, device="cuda")
    ocfg = OptimizerConfig()  # the repo's train cells' (launch/specs.py)

    def loss_on(p, b):
        return lm_loss(p, cfg, b, use_kernel=True, telemetry=True)

    def loss_off(p, b):
        return lm_loss(p, cfg, b, use_kernel=True)

    log(f"[lm] {cfg.name}: {cfg.num_layers} layers ({n_moe} Soft-MoE, "
        f"{cfg.moe.num_experts} experts x {cfg.moe.slots_per_expert} slot, "
        f"d_ff {cfg.moe.expert_d_ff}), d {cfg.d_model}, "
        f"{cfg.attention.num_heads} heads / {cfg.attention.num_kv_heads} KV "
        f"x {cfg.attention.head_dim}, vocab {cfg.vocab_size}, tied "
        f"{cfg.tie_embeddings}; scan_layers={cfg.scan_layers} "
        f"remat={cfg.remat}; {n_params} params ({n_params / 1e9:.4f} B); "
        f"train state (f32 params, AdamW mu and nu, step) {state_bytes} "
        f"bytes = {state_bytes / 2**30:.3f} GiB (init "
        f"{time.perf_counter() - t0:.1f} s); compute {cfg.dtype}, batch "
        f"{batch} x {seq} tokens of SyntheticLM")

    # Step 0, the same params and batch: the kernel path's loss and every
    # layer's telemetry against the einsum path's, in bf16. Bounds: the
    # loss within 1e-3 of itself; each telemetry leaf (24 layers stacked,
    # rows included) within 2e-2 of its largest value. The einsum path
    # normalizes x in bf16, the kernels in f32 (a logit moves by ~2^-9),
    # and every later bf16 rounding of the residual stream adds up to 2^-8
    # over 24 layers.
    b0 = data.batch(0)
    with torch.no_grad():
        lk, mk = lm_loss(state["params"], cfg, b0, use_kernel=True,
                         telemetry=True)
        le, me = lm_loss(state["params"], cfg, b0, use_kernel=False,
                         telemetry=True)
    loss_err = abs(float(lk) - float(le)) / abs(float(le))
    rows, worst = [], 0.0

    def walk(a, b_, path):
        nonlocal worst
        if isinstance(b_, dict):
            for k in b_:
                walk(a[k], b_[k], f"{path}.{k}" if path else str(k))
            return
        diff = (a.float() - b_.float()).abs().max()
        top = b_.float().abs().max()  # a count of 0 is held exactly
        err = (diff / top if top > 0 else diff).item()
        worst = max(worst, err)
        rows.append((path, err, tuple(a.shape)))

    walk(mk["telemetry"], me["telemetry"], "")
    flat_k, flat_e = (flatten_telemetry(m["telemetry"]) for m in (mk, me))
    log(f"[lm] step 0 in bf16, kernel vs einsum path: loss {float(lk):.6f} "
        f"vs {float(le):.6f} (ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.6f}), rel diff {loss_err:.3e} (tol "
        f"1e-3); telemetry max|diff| / max|ref| per leaf (tol 2e-2): "
        + " ".join(f"{p}{list(sh)}={e:.3e}" for p, e, sh in rows))
    log(f"[lm] step 0 flat telemetry, kernel path: "
        + " ".join(f"{k}={v:.6g}" for k, v in flat_k.items()))
    if loss_err > 1e-3 or worst > 2e-2 or set(flat_k) != set(flat_e):
        raise AssertionError("kernel-path loss or telemetry disagrees with "
                             "the einsum path")
    del mk, me

    # one MoE layer in f32 on the input the model feeds it (captured from
    # its own forward): every telemetry leaf within 1e-4 of its largest
    # value (sums in other orders)
    seen, inner = [], lm.moe_apply

    def capture(p, moe_cfg, xn, *a, **kw):
        seen.append((p, moe_cfg, xn))
        return inner(p, moe_cfg, xn, *a, **kw)

    lm.moe_apply = capture
    try:
        with torch.no_grad():
            lm_loss(state["params"], cfg, b0, use_kernel=True)
    finally:
        lm.moe_apply = inner
    p_moe, moe_cfg, xn = seen[0]
    seen.clear()
    with torch.no_grad():
        tk = soft_moe_apply(p_moe, moe_cfg, xn.float(), cfg.act,
                            use_kernel=True, telemetry=True)[1]["telemetry"]
        te = soft_moe_apply(p_moe, moe_cfg, xn.float(), cfg.act,
                            telemetry=True)[1]["telemetry"]
    rows, worst = [], 0.0
    walk(tk, te, "")
    log(f"[lm] layer {cfg.moe_layer_indices()[0]} alone in f32 on its "
        f"captured input, telemetry "
        f"kernel vs einsum path, max|diff| / max|ref| (tol 1e-4): "
        + " ".join(f"{p}={e:.3e}" for p, e, _ in rows))
    if worst > 1e-4:
        raise AssertionError("f32 layer telemetry disagrees")
    del p_moe, xn, tk, te

    # The main path: the Trainer drives make_train_step on the telemetry
    # loss and logs the flattened telemetry every step; counts from 0.
    ckpt_dir = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_steps = 7
    trainer = Trainer(
        TrainerConfig(total_steps=n_steps, checkpoint_every=10**9,
                      checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
                      log_every=1),
        loss_on, None, ocfg, data)
    save = trainer.ckpt.save
    saved = {}

    def timed_save(*a, **kw):  # the Trainer's closing save of the state
        t = time.perf_counter()
        save(*a, **kw)
        saved["s"] = time.perf_counter() - t

    trainer.ckpt.save = timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state = trainer.run(torch.Generator(device="cuda").manual_seed(0),
                        start_state=state)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = trainer.metrics_history
    times = [m["step_time"] for m in hist]
    p50 = statistics.median(times)
    want = (2 * n_moe, 2 * n_moe, 0, n_moe, n_moe, n_moe)
    tkeys = sorted(k for k in hist[-1] if k.startswith("telemetry_"))
    log(f"[lm] {card}: Trainer steps 0-{n_steps - 1} (telemetry on): step "
        f"p50 {p50 * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}) = {batch * seq / p50:.1f} tokens/s; loss "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; peak device "
        f"memory {peak / 2**30:.3f} GiB (state {state_bytes / 2**30:.2f} "
        f"GiB); launches {show(launches)} (= {n_steps} x {show(want)}: "
        f"remat runs each MoE layer's forward twice, K6 only in the "
        f"first); closing save of the whole state {state_bytes / 1e9:.2f} GB "
        f"in {saved.get('s', float('nan')):.2f} s; {len(tkeys)} telemetry "
        f"keys logged, e.g. "
        + " ".join(f"{k}={hist[-1][k]:.5g}" for k in tkeys[:8]))
    if launches != tuple(n_steps * c for c in want):
        raise AssertionError(f"LM train-step launches {launches} do not "
                             f"match {n_steps} x {want}")
    if not all(math.isfinite(m["loss"]) for m in hist) or not tkeys or \
            not all(math.isfinite(m[k]) for m in hist for k in tkeys):
        raise AssertionError("non-finite loss or telemetry, or none logged")

    # telemetry off beside on, in turns (off, on, on, off) x 2, the same
    # clock (the step's call to a host sync on its loss)
    step_on = make_train_step(loss_on, ocfg)
    step_off = make_train_step(loss_off, ocfg)
    turns = {"on": [], "off": []}
    zero_counts()
    for i, key in enumerate(["off", "on", "on", "off"] * 2):
        b = data.batch(n_steps + i)
        t0 = time.perf_counter()
        state, m = (step_on if key == "on" else step_off)(state, b)
        float(m["total_loss"])
        turns[key].append(time.perf_counter() - t0)
    k6 = routing_health.launches
    on50, off50 = (statistics.median(turns[k]) for k in ("on", "off"))
    log(f"[lm] {card}: telemetry on vs off in turns: step p50 "
        f"{on50 * 1e3:.2f} ms vs {off50 * 1e3:.2f} ms "
        f"({batch * seq / on50:.1f} vs {batch * seq / off50:.1f} tokens/s; "
        f"on/off "
        f"{on50 / off50:.4f}); K6 launches {k6} (= 4 x {n_moe}: none with "
        f"telemetry off)")
    if k6 != 4 * n_moe:
        raise AssertionError("K6 ran with telemetry off")

    # Where the time goes: one profiled step with telemetry on
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = data.batch(n_steps + 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_on(state, b)
        float(m["total_loss"])
        pwall = time.perf_counter() - t0
    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, cnt = per.get(ev.name, (0.0, 0))
            per[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((k, us, c) for k, (us, c) in per.items()),
                  key=lambda r: -r[1])
    busy = sum(us for _, us, _ in rows) / 1e6
    log(f"[profile] lm train {card}: one step in {pwall * 1e3:.1f} ms wall "
        f"under the profiler; device busy {busy * 1e3:.1f} ms = "
        f"{busy / pwall:.3f} of wall")
    kinds = {}
    for name, us, cnt in rows:
        k = kernel_kind(name)
        kinds[k] = (kinds.get(k, (0.0, 0))[0] + us,
                    kinds.get(k, (0.0, 0))[1] + cnt)
    for k, (us, cnt) in sorted(kinds.items(), key=lambda r: -r[1][0]):
        log(f"[profile]   {k}: {us / 1e3:.2f} ms in {cnt} launches "
            f"({us / 1e6 / busy:.3f} of device time)")
    for name, us, cnt in rows[:12]:
        log(f"[profile]   top: {us / 1e3:.2f} ms x{cnt} {name[:90]}")
    del state, trainer, step_on, step_off
    torch.cuda.empty_cache()
    return {"routing_health": launches[5]}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def main():
    try:
        import torch

        card = phase_device(torch)
        phase_build()
        kern = phase_kernels(torch)
        kern.update(phase_soft_moe_kernels(torch))
        kern.update(phase_soft_moe_bwd_kernels(torch))
        kern.update(phase_routing_health(torch))
        launches = phase_serve(torch, card)
        launches.update(phase_vit(torch, card))
        launches.update(phase_train(torch, card))
        launches.update(phase_lm_train(torch, card))
    except Exception as e:  # noqa: BLE001 — report which phase failed
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr,
              flush=True)
        raise SystemExit(1)
    rows = []
    for name, meta in KERNEL_SOURCES.items():
        rows.append({"name": name, **meta, "launches": launches[name],
                     **kern[name]})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
