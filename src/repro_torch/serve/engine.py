"""Continuous-batching serving engine over the contiguous (the default,
as in the reference) or the paged cache backend, counterpart of
``ServeEngine`` in ``repro/serve/engine.py``.

Requests are admitted the moment the backend has a slot and blocks for
them, prompts prefill in fixed-size chunks interleaved with decode
steps, every decode tick advances ALL live rows in one batched model
call, and a row retires (its memory released, the next request
admitted) the tick it samples EOS or exhausts its budget. On the
contiguous backend each slot owns a ``max_len`` ring row and decode
attention gathers it, as in the reference (no kernel runs). On the paged
backend decode attention runs the paged decode-attention kernel on CUDA
(``use_kernel=True``, the default) or the gather path; MLA models always
gather, as in the reference. SSM and hybrid models keep each slot's
recurrent state in the backend and serve without the prefix cache, as
in the reference. An encoder-decoder config serves its decoder stack
with the frontend projection prepended, as the reference's engine does.
MoE LMs serve with per-row dropless routing (the sparse variants'
serving modes) on the MoE einsum path, as in the reference;
``telemetry=True`` collects the model-interior telemetry of every call
(``serve/telemetry.py``).

``WaveEngine`` keeps the wave-synchronous baseline: a wave of requests
admits together, prefills whole, decodes in lockstep and holds every
slot until its last row ends.

``spec`` serves through speculative decoding (``serve/spec_decode.py``),
``cache_generated`` publishes retired requests' generated tokens into
the radix tree, ``trace`` records per-request span timelines and
``flight_recorder`` keeps a ring of per-tick records
(``serve/tracing.py``); the last two are host-side only and change no
served token.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..layers.common import dtype_of, resolve_device
from ..models import init_cache, lm_apply
from ..models.lm import check_supported
from ..roofline import serving_program_bounds
from .block_manager import PagedBackend
from .cache_pool import ContiguousBackend
from .programs import make_decode_step
from .sampling import (
    GREEDY,
    SamplingParams,
    sample_tokens,
    sample_tokens_checked,
    stack_params,
)
from .scheduler import Request, Scheduler
from .spec_decode import SpecConfig, SpecDecoder
from .telemetry import TelemetryAggregator
from .tracing import (
    SPAN_ADMITTED,
    SPAN_DECODE_TICK,
    SPAN_PREEMPTED,
    SPAN_PREFILL_CHUNK,
    SPAN_REQUEUED,
    SPAN_RETIRED,
    FlightRecorder,
    ProgramTimer,
    Tracer,
)

# Layer weights the reference reads in f32 whatever the compute dtype, by
# the sub-dict that holds them: a MoE layer's routing weights (the sparse
# router, Soft MoE's phi and scale: their logits are f32), MLA's
# up-projections (its absorbed products run in f32) and the SSM's decay,
# skip and step bias (its dt, A and D terms are f32)
_F32_WEIGHTS = {"moe": ("router", "phi", "scale"), "attn": ("w_uk", "w_uv"),
                "ssm": ("A_log", "D", "dt_bias")}


def serving_params(params, cfg):
    """Params as the serving programs use them: every weight cast once to
    the compute dtype, except the embedding tables, which the unembed
    reads in f32, and the weights of ``_F32_WEIGHTS`` (a MoE layer's
    ``router``, ``phi``, ``scale``; MLA's ``w_uk``, ``w_uv``; the SSM's
    ``A_log``, ``D``, ``dt_bias``), kept in
    their stored dtype because the layers compute with them in f32. The
    layers cast every other weight to the activation dtype at each use,
    so this gives the same numbers without the per-step casts. A weight
    already in the compute dtype is kept as it is, not copied."""
    dt = dtype_of(cfg.dtype)

    def cast(tree, keep=()):
        return {k: cast(v, _F32_WEIGHTS.get(k, ())) if isinstance(v, dict)
                else v if k in keep else v.to(dt)
                for k, v in tree.items()}

    out = dict(params)
    out["layers"] = [cast(p) for p in params["layers"]]
    out["final_norm"] = cast(params["final_norm"])
    return out


class ServeEngine:
    """Continuous-batching serving engine.

    batch_size is the number of decode rows (= max concurrent requests);
    max_len caps prompt+generation per request. Per-request sampling
    comes from Request.sampling; ``default_sampling`` fills in for
    requests that keep the dataclass default. ``backend`` is
    ``"contiguous"`` (one max_len ring row per slot) or ``"paged"``; the
    paged backend takes ``block_size`` tokens per KV block,
    ``num_blocks`` total pool blocks (default: one max_len row per slot),
    ``prefix_cache`` (share common prompt prefixes through the radix
    tree) and ``use_kernel`` (the paged decode-attention kernel, the
    default, or the gather path). ``device`` is where the model and the
    pools live (``"cuda"`` unless the caller asks for ``"cpu"``).
    ``telemetry=True`` drains each call's telemetry tree into
    ``self.telemetry`` (a ``TelemetryAggregator``: ``tick`` holds the
    current tick's flat stats per phase) and ``telemetry_snapshot()``.
    ``cache_generated`` (paged only) also publishes retired requests'
    generated tokens into the radix tree (multi-turn prefix reuse).

    ``max_queue`` bounds the admission queue (`submit` raises
    `scheduler.QueueFull`); the tick loop enforces per-request deadlines,
    `cancel(req)` frees a queued or live request within one tick, and
    rows whose logits go non-finite retire with finish_reason="error".

    ``spec`` (a ``SpecConfig``) turns on speculative decoding: a
    self-drafting n-gram drafter proposes up to ``spec.k`` tokens a row
    and one batched (B, k+1) verify step commits an accepted prefix; the
    stream is token for token the plain engine's on the same logits.
    ``trace`` records span timelines on each request (``req.spans``);
    ``flight_recorder=N`` keeps the last N tick records
    (``self.recorder``).
    """

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 default_sampling: SamplingParams = GREEDY,
                 prefill_chunk: Optional[int] = None,
                 cache_dtype=torch.bfloat16, backend: str = "contiguous",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, use_kernel: bool = True,
                 cache_generated: bool = False,
                 spec: Optional[SpecConfig] = None,
                 max_queue: Optional[int] = None, trace: bool = False,
                 flight_recorder: int = 0, telemetry: bool = False,
                 device="cuda"):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = serving_params(params, cfg)
        self.batch = batch_size
        self.max_len = max_len
        self.pad_id = pad_id
        self.default_sampling = default_sampling
        if backend == "contiguous":
            if cache_generated:
                raise ValueError(
                    "cache_generated needs the paged backend's radix tree")
            self.backend = ContiguousBackend(
                cfg, batch_size, max_len, dtype_of(cache_dtype),
                telemetry=telemetry, device=self.device)
        elif backend == "paged":
            self.backend = PagedBackend(
                cfg, batch_size, max_len, dtype_of(cache_dtype),
                block_size=block_size, num_blocks=num_blocks,
                prefix_cache=prefix_cache, use_kernel=use_kernel,
                cache_generated=cache_generated, telemetry=telemetry,
                device=self.device,
            )
        else:
            raise ValueError(f"unknown backend {backend!r}")
        # drains the backend's per-call (phase, tree) stash each phase
        self.telemetry = TelemetryAggregator() if telemetry else None
        chunk = prefill_chunk or min(32, self.backend.max_chunk)
        if chunk > self.backend.max_chunk:
            raise ValueError(f"prefill_chunk {chunk} exceeds backend limit "
                             f"{self.backend.max_chunk}")
        self.sched = Scheduler(chunk, max_len, eos_id, max_queue=max_queue)
        # Sampler fused with the per-row non-finite guard.
        self._sample = sample_tokens_checked
        # Per-slot logits of the *last* model call that touched the row —
        # valid iff the row is in DECODE state.
        self._logits = torch.zeros((batch_size, cfg.vocab_size),
                                   dtype=torch.float32, device=self.device)
        # Per-slot sampling parameter arrays (host; fixed shapes).
        self._temp = np.zeros((batch_size,), np.float32)
        self._top_k = np.zeros((batch_size,), np.int32)
        self._top_p = np.ones((batch_size,), np.float32)
        self._seed = np.zeros((batch_size,), np.int32)
        self._step = np.zeros((batch_size,), np.int32)
        self.decode_steps = 0  # batched decode model calls (perf counter)
        self.preemptions = 0
        self.cancellations = 0
        self.nonfinite_retired = 0
        self.deadline_misses = {"ttft": 0, "total": 0}
        # Speculative decoding: SpecDecoder refuses archs and backends it
        # cannot roll back, and owns drafting, verify and accept state.
        self._spec = SpecDecoder(self, spec) if spec is not None else None
        # Set by a preemption while other rows are live: admission pauses
        # until one of them RETIRES, or two equal-sized rows livelock.
        self._admission_hold = False
        # Observability: span timelines and the tick ring, host side only.
        self.tracer = Tracer() if trace else None
        self.recorder = (FlightRecorder(flight_recorder)
                         if flight_recorder else None)
        self.ticks = 0
        self._timers = {}
        if self.recorder is not None or telemetry:
            # Host timers around the backend's model entry points and the
            # sampler. FaultInjector attaches after construction and
            # wraps whatever is bound then, so injected faults stay timed
            # and detach() restores the timed methods.
            for name in ("prefill_chunk", "decode", "verify"):
                timer = ProgramTimer(name, getattr(self.backend, name))
                setattr(self.backend, name, timer)
                self._timers[name] = timer
            self._sample = ProgramTimer("sample", self._sample)
            self._timers["sample"] = self._sample

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request):
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({len(req.prompt)}) + max_new({req.max_new_tokens}) "
                f"exceeds max_len {self.max_len}"
            )
        if not self.backend.accepts(len(req.prompt), req.max_new_tokens):
            raise ValueError(
                f"request needs more cache than the backend owns "
                f"(prompt {len(req.prompt)} + max_new {req.max_new_tokens})"
            )
        self.sched.submit(req)
        if self.tracer is not None:
            self.tracer.start(req)

    # -- tick phases -------------------------------------------------------

    def _admit(self) -> int:
        admitted = 0
        while self.sched.has_queued() and not self._admission_hold:
            res = self.backend.try_admit(self.sched.peek())
            if res is None:
                break  # FIFO: head blocks until memory frees
            slot, cached_len = res
            entry = self.sched.bind(slot, start_pos=cached_len)
            admitted += 1
            if self.tracer is not None:
                self.tracer.span(entry.req, SPAN_ADMITTED, slot=slot,
                                 cached=cached_len)
            sp = entry.req.sampling
            if sp is GREEDY:
                sp = self.default_sampling
                entry.req.sampling = sp
            self._temp[slot] = sp.temperature
            self._top_k[slot] = sp.top_k
            self._top_p[slot] = sp.top_p
            self._seed[slot] = sp.seed
            self._step[slot] = 0
        return admitted

    def _do_prefill_chunk(self) -> bool:
        entry = self.sched.next_prefill()
        if entry is None:
            return False
        chunk_i = entry.next_chunk
        toks, poss = entry.take_chunk()
        self._logits = self._call_model(
            [entry], self.backend.prefill_chunk, self._logits, entry.slot,
            toks, poss)
        if self.tracer is not None:
            self.tracer.span(entry.req, SPAN_PREFILL_CHUNK, i=chunk_i,
                             of=entry.n_chunks)
        if entry.prefill_done():
            self.backend.prefill_finished(entry)
        return True

    def _preempt(self, entry):
        """Out of cache memory mid-decode: reclaim the row and put the
        request back at the head of the queue for a full restart, with
        its own prefix-cache hits disabled so eviction can always reclaim
        enough blocks to finish it."""
        if self.tracer is not None:
            self.tracer.span(entry.req, SPAN_PREEMPTED, slot=entry.slot,
                             discarded=len(entry.req.out))
        self.backend.retire(entry.slot)
        self.sched.requeue(entry)
        if self.tracer is not None:
            self.tracer.span(entry.req, SPAN_REQUEUED)
        entry.req.no_prefix_cache = True
        self.preemptions += 1
        if self._spec is not None:
            self._spec.drop_slot(entry.slot)
        # Hold admission until a live row retires and genuinely frees
        # memory; with no other live row the restart owns the whole pool.
        self._admission_hold = bool(self.sched.live)

    def _retire_entry(self, entry):
        """Normal completion: let the backend publish reusable state
        (``cache_generated``), release the slot, unblock admission."""
        self.backend.cache_finished(entry)
        self.backend.retire(entry.slot)
        if self._spec is not None:
            self._spec.drop_slot(entry.slot)
        self._admission_hold = False
        if self.tracer is not None:
            attrs = {"reason": entry.req.finish_reason}
            if self.telemetry is not None:
                # the latest decode numerics the request retired under
                flat = self.telemetry.latest.get("decode", {})
                for k in ("logits_max_abs_logit", "logits_softmax_entropy"):
                    if k in flat:
                        attrs[k] = round(flat[k], 6)
            self.tracer.span(entry.req, SPAN_RETIRED, **attrs)

    def _call_model(self, entries, program, *args):
        """One backend model call for ``entries``. If it raises (say, a
        kernel that fails to build or launch), those rows first retire
        with finish_reason="error" and free their memory, then the error
        propagates: nothing falls back, and the engine stays consistent
        for the caller, who may keep stepping it."""
        try:
            return program(self.params, *args)
        except Exception:
            for e in entries:
                self._abort_entry(e, "error")
            raise

    def _abort_entry(self, entry, reason: str):
        """Abnormal retirement (cancellation / deadline / poisoned row):
        release everything the row holds (slot, blocks, pending
        speculative state) in the same tick, without publishing any of
        its state to the prefix cache."""
        self.sched.finish(entry, reason)
        self.backend.retire(entry.slot)
        if self._spec is not None:
            self._spec.drop_slot(entry.slot)
        self._admission_hold = False
        if self.tracer is not None:
            self.tracer.span(entry.req, SPAN_RETIRED, reason=reason)

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Cancel a request wherever it is (queued or live). Returns
        False if the request already finished."""
        if req.done:
            return False
        if self.sched.drop_queued(req, reason):
            self.cancellations += 1
            if self.tracer is not None:
                self.tracer.span(req, SPAN_RETIRED, reason=reason)
            return True
        entry = self.sched.entry_for(req)
        if entry is None:
            return False
        self._abort_entry(entry, reason)
        self.cancellations += 1
        return True

    @staticmethod
    def _deadline_kind(req: Request, now: float) -> Optional[str]:
        if (req.deadline_s is not None
                and now - req.t_submit >= req.deadline_s):
            return "total"
        if (req.ttft_deadline_s is not None and req.t_first_token == 0.0
                and now - req.t_submit >= req.ttft_deadline_s):
            return "ttft"
        return None

    def _expire_deadlines(self):
        """Queued requests whose deadline passed never bind memory; live
        rows are aborted and their resources free this same tick."""
        now = time.perf_counter()
        for req in [r for r in self.sched.queue
                    if r.ttft_deadline_s is not None
                    or r.deadline_s is not None]:
            kind = self._deadline_kind(req, now)
            if kind is not None:
                self.sched.drop_queued(req, "deadline")
                self.deadline_misses[kind] += 1
                if self.tracer is not None:
                    self.tracer.span(req, SPAN_RETIRED, reason="deadline")
        for entry in list(self.sched.live.values()):
            kind = self._deadline_kind(entry.req, now)
            if kind is not None:
                self._abort_entry(entry, "deadline")
                self.deadline_misses[kind] += 1

    def _do_decode(self) -> int:
        """Sample every DECODE row from the logits buffer, retire finished
        rows, then one batched decode step for the survivors. Returns the
        number of tokens emitted. With speculation on, the phase is the
        SpecDecoder's (draft, one (B, k+1) verify, accept and roll back)."""
        if self._spec is not None:
            return self._spec.decode_tick()
        entries = self.sched.decode_entries()
        if not entries:
            return 0
        toks, ok = self._sample(
            self._logits, self._temp, self._top_k, self._top_p,
            self._seed, self._step,
        )
        toks, ok = toks.cpu().numpy(), ok.cpu().numpy()
        in_toks = np.full((self.batch, 1), self.pad_id, np.int64)
        in_pos = np.full((self.batch,), -1, np.int32)
        emitted = 0
        survivors = []
        for e in entries:
            if not ok[e.slot]:
                # Poisoned logits: retire the row instead of committing a
                # garbage token — the other rows' streams are untouched.
                self._abort_entry(e, "error")
                self.nonfinite_retired += 1
                continue
            tok = int(toks[e.slot])
            self._step[e.slot] += 1
            emitted += 1
            finished = self.sched.record_token(e, tok)
            if self.tracer is not None:
                self.tracer.span(e.req, SPAN_DECODE_TICK, token=tok)
            if finished:
                self._retire_entry(e)
            elif not self.backend.ensure_decode_block(e.slot, e.pos):
                self._preempt(e)
            else:
                in_toks[e.slot, 0] = tok
                in_pos[e.slot] = e.pos
                survivors.append(e)
        if survivors:
            logits = self._call_model(
                survivors, self.backend.decode,
                torch.as_tensor(in_toks, device=self.device),
                torch.as_tensor(in_pos, device=self.device),
            )
            self._logits = logits[:, 0].to(torch.float32)
            self.decode_steps += 1
            for e in survivors:
                e.pos += 1
        return emitted

    def step(self) -> int:
        """One engine tick: expire deadlines, admit, (maybe) one prefill
        chunk, one batched sample+decode pass. Returns tokens emitted.
        A model call that raises retires its rows (``_call_model``) and
        the error propagates out of the tick. With a recorder the tick
        appends one flight-recorder record."""
        t0 = time.perf_counter() if self.recorder is not None else 0.0
        self._expire_deadlines()
        if self.telemetry is not None:
            self.telemetry.begin_tick()
        admitted = self._admit()
        prefilled = self._do_prefill_chunk()
        if self.telemetry is not None:
            self.telemetry.drain(self.backend)
        emitted = self._do_decode()
        if self.telemetry is not None:
            self.telemetry.drain(self.backend)
        self.ticks += 1
        if self.recorder is not None:
            self.recorder.record({
                "tick": self.ticks,
                "t": t0,
                "wall_s": round(time.perf_counter() - t0, 6),
                "queued": len(self.sched.queue),
                "live": len(self.sched.live),
                "decode_rows": len(self.sched.decode_entries()),
                "admitted": admitted,
                "prefilled": int(prefilled),
                "emitted": emitted,
                "kernel_fallbacks": 0,  # see robustness_stats
                "jit_cache_sizes": self.jit_cache_sizes(),
                "programs": {name: t.take_tick()
                             for name, t in self._timers.items()},
                **self.backend.occupancy(),
                **({"telemetry": dict(self.telemetry.tick)}
                   if self.telemetry is not None and self.telemetry.tick
                   else {}),
            })
        return emitted

    def run(self) -> int:
        """Drain queue + live rows to completion; returns total decode
        model calls."""
        while self.sched.pending():
            self.step()
        return self.decode_steps

    # -- introspection -----------------------------------------------------

    def jit_cache_sizes(self) -> tuple:
        """The reference's compiled-signature counts of its serving
        programs. The port runs its programs eagerly and compiles none, so
        this is the empty tuple (and so is the tick record's
        ``jit_cache_sizes``, kept so that both packages' records have one
        key set)."""
        return ()

    def config_info(self) -> dict:
        """Frozen engine configuration as flat str/int values: the
        exporter renders it as the ``engine_info{...} 1`` gauge, so a
        scrape says what was serving."""
        paged = isinstance(self.backend, PagedBackend)
        info = {
            "arch": str(self.cfg.name),
            "backend": "paged" if paged else "contiguous",
            "max_batch": self.batch,
            "max_len": self.max_len,
            "prefill_chunk": self.sched.prefill_chunk,
            "spec": "on" if self._spec is not None else "off",
            "trace": "on" if self.tracer is not None else "off",
        }
        if paged:
            be = self.backend
            info.update(
                block_size=be.block_size,
                num_blocks=be.num_blocks,
                use_kernel="on" if be.use_kernel else "off",
                prefix_cache="on" if be.prefix is not None else "off",
                cache_generated="on" if be.cache_generated else "off",
            )
        if self._spec is not None:
            info["spec_k"] = self._spec.k
        return info

    def robustness_stats(self) -> dict:
        """Degradation and termination counters (``serve/metrics.py``
        merges them into the server's metric snapshot).
        ``kernel_fallbacks`` is always 0: the port has no kernel-to-gather
        fallback (a failing kernel raises), and the key is kept so that
        both packages' counters and tick records have one key set."""
        out = {
            "preemptions": self.preemptions,
            "cancellations": self.cancellations,
            "nonfinite_retired": self.nonfinite_retired,
            "deadline_misses_ttft": self.deadline_misses["ttft"],
            "deadline_misses_total": self.deadline_misses["total"],
            "kernel_fallbacks": 0,
        }
        if self._spec is not None:
            out["spec_rows_disabled"] = self._spec.rows_disabled
            out["spec_drafter_errors"] = self._spec.drafter_errors
        return out

    def spec_stats(self) -> Optional[dict]:
        """Speculation counters (None when speculation is off)."""
        if self._spec is None:
            return None
        s = self._spec
        return {
            "verify_calls": s.verify_calls,
            "drafted": s.drafted,
            "accepted": s.accepted,
            "tokens_emitted": s.tokens_emitted,
            "acceptance_rate": s.acceptance_rate,
            "calls_per_token": s.calls_per_token(),
        }

    def peak_cache_bytes(self) -> int:
        return self.backend.peak_cache_bytes()

    def telemetry_snapshot(self) -> dict:
        """Latest flat model-interior stats per phase (empty when
        telemetry is off): ``{"decode": {"moe_l2_router_entropy": ...,
        "logits_max_abs_logit": ...}, "prefill": {...}}``."""
        if self.telemetry is None:
            return {}
        return {phase: dict(flat)
                for phase, flat in self.telemetry.latest.items()}

    def program_efficiency(self) -> dict:
        """Each program's least time on the H100
        (``roofline.serving_program_bounds``) over its ``ProgramTimer``
        mean HOST wall time, the ``program_efficiency`` gauge. On CUDA the
        timer reads launch time plus any wait inside the call, not device
        time, so this is a host-time ratio, not a device roofline share.
        Empty until a program has run under a timer (telemetry or a
        flight recorder)."""
        if not self._timers:
            return {}
        lanes = (self._spec.k + 1) if self._spec is not None else 1
        bounds = serving_program_bounds(
            self.cfg, self.batch, self.sched.prefill_chunk, lanes)
        out = {}
        for name, timer in self._timers.items():
            if name not in bounds or timer.calls == 0:
                continue
            measured = timer.total_s / timer.calls
            out[name] = bounds[name] / measured if measured > 0 else 0.0
        return out


# ---------------------------------------------------------------------------
# Wave-synchronous baseline
# ---------------------------------------------------------------------------


class WaveEngine:
    """The pre-continuous engine, counterpart of the reference's
    ``WaveEngine``: a wave of up to ``batch_size`` requests admits
    together, prefills in one whole-prompt call on a fresh ``init_cache``,
    decodes in lockstep, and every slot is held until the LAST row of the
    wave finishes. The baseline every serving comparison measures against.

    Prompts are right-aligned, so every row's last prompt token sits at
    the same index; left pads carry ``pad_id`` at position -1, which
    writes nothing and is masked out of attention. Decoding runs through
    the contiguous decode program (no kernel, as in the reference) until
    the longest budget ends or a row reaches ``max_len``. Sampled rows use
    the port's per-row seeds (``sampling._row_seed``). ``device`` is
    where the model and the cache live (``"cuda"`` unless the caller asks
    for ``"cpu"``)."""

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 default_sampling: SamplingParams = GREEDY, seed: int = 0,
                 device="cuda"):
        del seed  # the reference's signature; sampling is seeded per row
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = serving_params(params, cfg)
        self.batch = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.default_sampling = default_sampling

        def prefill(params, tokens, positions, cache):
            logits, cache, _ = lm_apply(params, cfg, tokens,
                                        positions=positions, cache=cache,
                                        mode="prefill", last_only=True)
            return logits, cache

        self._prefill = prefill
        self._decode = make_decode_step(cfg)
        self.queue: List[Request] = []
        self.decode_steps = 0

    def peak_cache_bytes(self) -> int:
        """Bytes of one wave's cache, built on the meta device: shapes and
        dtypes only, nothing allocated."""
        cache = init_cache(self.cfg, self.batch, self.max_len,
                           device="meta")
        return sum(t.numel() * t.element_size()
                   for layer in cache for part in layer.values()
                   for t in part.values())

    def submit(self, req: Request):
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _sample_wave(self, wave, logits, step_base: int) -> np.ndarray:
        sp = [r.sampling if r.sampling is not GREEDY
              else self.default_sampling for r in wave]
        sp += [GREEDY] * (self.batch - len(wave))
        st = stack_params(sp)
        toks = sample_tokens(
            logits[:, -1].float(), st["temperature"], st["top_k"],
            st["top_p"], st["seed"],
            np.full((self.batch,), step_base, np.int32),
        )
        return toks.cpu().numpy()

    def _run_wave(self, wave: List[Request]) -> int:
        plen = max(len(r.prompt) for r in wave)
        toks = np.full((self.batch, plen), self.pad_id, np.int64)
        poss = np.full((self.batch, plen), -1, np.int64)
        for i, r in enumerate(wave):
            # right-align so the last prompt token sits at index plen-1
            toks[i, plen - len(r.prompt):] = r.prompt
            poss[i, plen - len(r.prompt):] = np.arange(len(r.prompt))
        cache = init_cache(self.cfg, self.batch, self.max_len,
                           device=self.device)
        logits, cache = self._prefill(
            self.params, torch.as_tensor(toks, device=self.device),
            torch.as_tensor(poss, device=self.device), cache)
        nxt = self._sample_wave(wave, logits, 0)
        now = time.perf_counter()
        for i, r in enumerate(wave):
            r.out.append(int(nxt[i]))
            r.t_first_token = now
        steps = 0
        budget = max(r.max_new_tokens for r in wave)
        pos = np.array([len(r.prompt) for r in wave]
                       + [0] * (self.batch - len(wave)), np.int64)
        cur = nxt[:, None]
        while steps < budget - 1 and int(pos.max()) < self.max_len:
            logits = self._decode(
                self.params, torch.as_tensor(cur, device=self.device),
                torch.as_tensor(pos, device=self.device), cache)
            self.decode_steps += 1
            nxt = self._sample_wave(wave, logits, steps + 1)
            now = time.perf_counter()
            for i, r in enumerate(wave):
                if not r.done and len(r.out) < r.max_new_tokens:
                    tok = int(nxt[i])
                    r.out.append(tok)
                    if self.eos_id is not None and tok == self.eos_id:
                        r.done = True
                        r.finish_reason = "eos"
                        r.t_done = now
            cur = nxt[:, None]
            pos += 1
            steps += 1
        now = time.perf_counter()
        for r in wave:
            if not r.done:
                r.done = True
                r.finish_reason = ("length" if len(r.out) >= r.max_new_tokens
                                   else "cache_ceiling")
                r.t_done = now
        return steps + 1

    def run(self) -> int:
        """Run every queued wave to its end; returns the waves' sampling
        passes (prefill plus decode steps), as the reference does."""
        total = 0
        while self.queue:
            wave = self.queue[:self.batch]
            self.queue = self.queue[self.batch:]
            total += self._run_wave(wave)
        return total
