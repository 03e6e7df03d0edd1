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

Not ported yet: speculative decoding, span tracing and the flight
recorder (asking for them raises ``NotImplementedError``), and
publishing generated tokens into the radix tree (the JAX engine's
``cache_generated``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..layers.common import dtype_of, resolve_device
from ..models.lm import check_supported
from .block_manager import PagedBackend
from .cache_pool import ContiguousBackend
from .sampling import GREEDY, SamplingParams, sample_tokens_checked
from .scheduler import Request, Scheduler
from .telemetry import TelemetryAggregator

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

    ``max_queue`` bounds the admission queue (`submit` raises
    `scheduler.QueueFull`); the tick loop enforces per-request deadlines,
    `cancel(req)` frees a queued or live request within one tick, and
    rows whose logits go non-finite retire with finish_reason="error".
    """

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 default_sampling: SamplingParams = GREEDY,
                 prefill_chunk: Optional[int] = None,
                 cache_dtype=torch.bfloat16, backend: str = "contiguous",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, use_kernel: bool = True,
                 spec=None,
                 max_queue: Optional[int] = None, trace: bool = False,
                 flight_recorder: int = 0, telemetry: bool = False,
                 device="cuda"):
        for name, on in (("spec", spec is not None), ("trace", trace),
                         ("flight_recorder", flight_recorder)):
            if on:
                raise NotImplementedError(f"{name} is not ported yet")
        check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = serving_params(params, cfg)
        self.batch = batch_size
        self.max_len = max_len
        self.pad_id = pad_id
        self.default_sampling = default_sampling
        if backend == "contiguous":
            self.backend = ContiguousBackend(
                cfg, batch_size, max_len, dtype_of(cache_dtype),
                telemetry=telemetry, device=self.device)
        elif backend == "paged":
            self.backend = PagedBackend(
                cfg, batch_size, max_len, dtype_of(cache_dtype),
                block_size=block_size, num_blocks=num_blocks,
                prefix_cache=prefix_cache, use_kernel=use_kernel,
                telemetry=telemetry, device=self.device,
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
        # Set by a preemption while other rows are live: admission pauses
        # until one of them RETIRES, or two equal-sized rows livelock.
        self._admission_hold = False
        self.ticks = 0

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
        toks, poss = entry.take_chunk()
        self._logits = self.backend.prefill_chunk(
            self.params, self._logits, entry.slot, toks, poss
        )
        if entry.prefill_done():
            self.backend.prefill_finished(entry)
        return True

    def _preempt(self, entry):
        """Out of cache memory mid-decode: reclaim the row and put the
        request back at the head of the queue for a full restart, with
        its own prefix-cache hits disabled so eviction can always reclaim
        enough blocks to finish it."""
        self.backend.retire(entry.slot)
        self.sched.requeue(entry)
        entry.req.no_prefix_cache = True
        self.preemptions += 1
        # Hold admission until a live row retires and genuinely frees
        # memory; with no other live row the restart owns the whole pool.
        self._admission_hold = bool(self.sched.live)

    def _retire_entry(self, entry):
        """Normal completion: release the slot, unblock admission."""
        self.backend.retire(entry.slot)
        self._admission_hold = False

    def _abort_entry(self, entry, reason: str):
        """Abnormal retirement (cancellation / deadline / poisoned row):
        release everything the row holds in the same tick, without
        publishing any of its state to the prefix cache."""
        self.sched.finish(entry, reason)
        self.backend.retire(entry.slot)
        self._admission_hold = False

    def cancel(self, req: Request, reason: str = "cancelled") -> bool:
        """Cancel a request wherever it is (queued or live). Returns
        False if the request already finished."""
        if req.done:
            return False
        if self.sched.drop_queued(req, reason):
            self.cancellations += 1
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
        for entry in list(self.sched.live.values()):
            kind = self._deadline_kind(entry.req, now)
            if kind is not None:
                self._abort_entry(entry, "deadline")
                self.deadline_misses[kind] += 1

    def _do_decode(self) -> int:
        """Sample every DECODE row from the logits buffer, retire finished
        rows, then one batched decode step for the survivors. Returns the
        number of tokens emitted."""
        entries = self.sched.decode_entries()
        if not entries:
            return 0
        toks, ok = sample_tokens_checked(
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
            if self.sched.record_token(e, tok):
                self._retire_entry(e)
            elif not self.backend.ensure_decode_block(e.slot, e.pos):
                self._preempt(e)
            else:
                in_toks[e.slot, 0] = tok
                in_pos[e.slot] = e.pos
                survivors.append(e)
        if survivors:
            logits = self.backend.decode(
                self.params,
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
        chunk, one batched sample+decode pass. Returns tokens emitted."""
        self._expire_deadlines()
        if self.telemetry is not None:
            self.telemetry.begin_tick()
        self._admit()
        self._do_prefill_chunk()
        if self.telemetry is not None:
            self.telemetry.drain(self.backend)
        emitted = self._do_decode()
        if self.telemetry is not None:
            self.telemetry.drain(self.backend)
        self.ticks += 1
        return emitted

    def run(self) -> int:
        """Drain queue + live rows to completion; returns total decode
        model calls."""
        while self.sched.pending():
            self.step()
        return self.decode_steps

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
