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
4. serve: full-width qwen2-0.5b (24 layers, random weights from a seeded
   generator, bf16 compute) answers 16 greedy requests through
   ``ServeEngine(backend="paged")``; the kernel's launch count must equal
   decode steps x 24. A second kernel engine then runs the same requests,
   and a burst of 8 short ones that keeps every slot decoding, tick by
   tick beside a gather-path engine (``use_kernel=False``), teacher
   forced: the logits of every decoding row at every tick are held
   against the gather engine's.

The lines before the last carry the numbers: the card line as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
it, and one JSON object ``{"kernels": [...]}``. The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores (the kernel's arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

KERNEL_SOURCES = {
    "paged_decode_attend": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_attention_kernels.py:118",
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
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")


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
# phase 4: serve full-width qwen2-0.5b
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
    if "paged_decode_kernel" in name:
        return "K7 paged decode attention"
    if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "gemv")):
        return "matmul"
    return "other"


def phase_serve(torch, card):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_decode_attend
    from repro_torch.models import lm_init
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    params = lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main():
    try:
        import torch

        card = phase_device(torch)
        phase_build()
        kern = phase_kernels(torch)
        launches = phase_serve(torch, card)
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
