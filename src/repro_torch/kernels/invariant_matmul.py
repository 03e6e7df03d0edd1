"""Fixed-order f32 contractions: the CUDA kernel's wrappers, its launch
plan and their plain versions.

The kernel (``csrc/invariant_matmul.cu``, written for Hopper, built
with ``nvcc`` at first use and called through ctypes) replaces no Pallas
kernel. It computes f32 products that the reference leaves to XLA, in an
order that does not depend on the batch, so row i of an M-row launch, or
matrix i of an n-matrix launch, equals a 1-row or 1-matrix launch
bitwise, whatever M or n (rule 2 of the port). cuBLAS picks its f32
kernel, and with it the order of the sums, by the row and batch counts,
and the card's ``serve.telemetry.batch_variance_probe`` read ~1e-2 on
the sparse archs where the reference requires < 1e-5.

The order of every output element depends on K alone (``K_STEP``,
``K_CHUNK``): k in 8-wide steps in index order, each step one chain of
tensor-core products at f32 accuracy (split TF32: lo·hi, + hi·lo,
+ hi·hi, from zero), the steps' partials added in f32 into 256-wide chunk
sums, the chunk sums added in chunk order into the total. ``_plan``
chooses the rest, none of which moves a sum: the output tile (``TILES``:
16 x 64, 64 x 64 or 128 x 64), B's staged layout (q- or k-unit-stride,
read in place), 16- or 4-byte copies, and whether one CTA walks all
chunks or, when the grid would not fill the card, a cluster of one CTA a
chunk adds the chunk sums in the same order through shared memory. At
decode the kernel is bound by the bytes of the shared operand (the
router weight, the latent view) and by latency, which the split into
chunks spreads over more CTAs; at prefill and training's router rows by
issuing its products (three mma and the split of each operand value a
step), which run on the tensor cores in register-blocked warp tiles fed
by a 4-deep cp.async ring, two CTAs an SM.

The products routed through it:

* ``router_logits(x, w)``: the sparse MoE router logits
  (``core/sparse_moe.py::_router_logits``, the reference's
  ``core/sparse_moe.py:53``), in every mode, and the expert-parallel
  all-to-all layer's router (``distributed/a2a_routing.py``, the
  reference's ``distributed/a2a_routing.py:77``). Its gradient is the
  plain products dx = g wᵀ and dw = xᵀ g (``torch.matmul``), as the
  reference leaves them to XLA.
* ``batched_contract(a, b)``: MLA's f32 products on calls that need no
  gradient (serving), through ``layers/attention.py::_f32_contract``,
  each of which moved with the row count on the card: dense attention's
  scores q·kᵀ and weighted latent p·v when the keys are one group
  (``_attend`` with G = 1, MLA's latent view, batched over the rows; the
  reference's ``layers/attention.py:121`` and ``:128``), and the
  latent's expansion through ``w_uv``, batched over the heads
  (``_latent_up``, the reference's ``:527``). ``_f32_contract`` takes
  ``torch.bmm`` when an operand needs a gradient (training), so
  training attention keeps the library's product. MLA's absorbed query
  (``w_uk``, f32) read 0 at 4 rows against 1 and stays an einsum, as do
  the bf16 projections. GQA's grouped products (G > 1; no served GQA arch
  has one KV group at full width) stay einsums: the probe reads
  ≤ 1.9e-06 on qwen2-0.5b and hymba-1.5b.

Both launch the kernel for CUDA tensors and run the plain version (the
einsum that the reference's product is) for any other tensor: CPU
tensors, and the meta tensors of the dry-run (``launch/dryrun.py``),
which hold shapes only. There is no fallback: a CUDA call whose kernel
does not build or launch raises. An operand with no unit stride where
the kernel needs one is made contiguous first (the same values, the
same kernel).
``router_logits.launches`` and ``batched_contract.launches`` count
launches (never plain runs), so a caller can show that a run went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .recording import kernel_op


def router_logits_ref(x, w):
    """Plain version: (..., d) x (d, e) -> (..., e), one einsum."""
    return torch.einsum("...d,de->...e", x, w)


def batched_contract_ref(a, b):
    """Plain version: (n, p, k) x (n, k, q) -> (n, p, q), one einsum."""
    return torch.einsum("npk,nkq->npq", a, b)


def _check(name, t, ndim=None):
    """``t`` is an f32 tensor of ``ndim`` dims (None: at least one)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if (t.ndim < 1) if ndim is None else (t.ndim != ndim):
        raise ValueError(f"{name} has shape {tuple(t.shape)}: expected "
                         f"{ndim or 'at least 1'} dims")


def _router_shapes(x, w):
    _check("x", x)
    _check("w", w, 2)
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: "
                         f"contraction dims differ")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def _contract_shapes(a, b):
    _check("a", a, 3)
    _check("b", b, 3)
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         f"contract as (n, p, k) x (n, k, q)")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")


# The kernel's k order (csrc/invariant_matmul.cu: kTK, kChunk): the same
# for every launch.
K_STEP = 8      # one chain of tensor-core products from zero
K_TILE = 32     # k a pipeline stage
K_CHUNK = 256   # k a chunk sum
MAX_SPLIT = 8   # chunks a cluster can hold (a portable cluster)
# (rows, columns) of the output tiles. Tile 0 takes up to SMALL_ROWS rows
# (decode and short prefill chunks: the most CTAs); tile 1 at least
# LARGE_ROWS rows of at least 128 columns (prefill: the most reuse a
# staged value); tile 2 the rest (the routers at training's rows, mid-size
# prefill), where 128-row tiles left the card idle (PERF.md §6).
TILES = ((16, 64), (128, 64), (64, 64))
SMALL_ROWS, LARGE_ROWS = 256, 4096
FILL = 132      # CTAs that fill the H100 once (its SMs)


class Plan(NamedTuple):
    """One launch of the kernel. ``k_step``, ``k_tile``, ``k_chunk``,
    ``n_chunks`` and ``merge`` fix the order of every sum and depend on K
    alone; the rest place the work (the output tile, B's staged layout,
    the copy width, the CTAs a tile's chunks are spread over) and move no
    sum."""
    k_step: int
    k_tile: int
    k_chunk: int
    n_chunks: int
    merge: str
    tile: int
    b_k_fast: bool
    vec_a: bool
    vec_b: bool
    n_split: int
    grid: tuple


def _cdiv(x, y):
    return -(-x // y)


@functools.lru_cache(maxsize=1024)
def _plan(n, P, K, Q, a_strides, b_strides, a_aligned=True,
          b_aligned=True):
    """The launch plan of an (n, P, K) x (n, K, Q) product whose operands
    have element strides ``a_strides`` / ``b_strides`` (tuples; A
    k-unit-stride, B q- or k-unit-stride, as ``_unit_strided`` makes
    them) and data pointers 16-byte aligned or not. Cached: a serving
    step makes the same few calls every step."""
    sa_n, sa_p, _ = a_strides
    sb_n, sb_k, sb_q = b_strides
    n_chunks = max(1, _cdiv(K, K_CHUNK))
    b_k_fast = not (Q == 1 or sb_q == 1)
    if P <= SMALL_ROWS:
        tile = 0
    elif P >= LARGE_ROWS and Q >= 128:
        tile = 1
    else:
        tile = 2
    bm, bn = TILES[tile]

    def vec(aligned, *strides):
        return aligned and all(s % 4 == 0 for s in strides)

    vec_a = K % 4 == 0 and vec(a_aligned, *([sa_n] if n > 1 else []),
                                *([sa_p] if P > 1 else []))
    if b_k_fast:
        vec_b = K % 4 == 0 and vec(b_aligned, *([sb_n] if n > 1 else []),
                                    *([sb_q] if Q > 1 else []))
    else:
        vec_b = Q % 4 == 0 and vec(b_aligned, *([sb_n] if n > 1 else []),
                                    *([sb_k] if K > 1 else []))
    tiles = n * _cdiv(P, bm) * _cdiv(Q, bn)
    n_split = (n_chunks if 1 < n_chunks <= MAX_SPLIT and tiles < FILL
               else 1)
    return Plan(k_step=K_STEP, k_tile=K_TILE, k_chunk=K_CHUNK,
                n_chunks=n_chunks, merge="chunk order from 0", tile=tile,
                b_k_fast=b_k_fast, vec_a=vec_a, vec_b=vec_b,
                n_split=n_split,
                grid=(_cdiv(Q, bn) * n_split, _cdiv(P, bm), n))


def _unit_strided(a, b):
    """a with a unit k stride, b with a unit q or k stride: the operands
    as they are where they have one (every operand of the main path),
    else a contiguous copy. A dimension of one element needs none."""
    _, p, k = a.shape
    q = b.shape[2]
    if k > 1 and a.stride(2) != 1:
        a = a.contiguous()
    if not (q == 1 or b.stride(2) == 1 or k == 1 or b.stride(1) == 1):
        b = b.contiguous()
    return a, b


def _launcher():
    from .build import load

    fn = load("invariant_matmul").invariant_contract_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 3 + [i] * 4 + [ll] * 6 + [i] * 5 + [p]
        fn.restype = ctypes.c_int
    return fn


def _contract_cuda(a, b):
    """Launch the kernel on (n, p, k) x (n, k, q) f32 views; returns a
    contiguous (n, p, q) f32 tensor."""
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    a, b = _unit_strided(a, b)
    n, p, k = a.shape
    q = b.shape[2]
    plan = _plan(n, p, k, q, a.stride(), b.stride(),
                 a.data_ptr() % 16 == 0, b.data_ptr() % 16 == 0)
    out = torch.empty((n, p, q), dtype=torch.float32, device=a.device)
    fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, p, k, q,
                 *a.stride(), *b.stride(), plan.tile, int(plan.b_k_fast),
                 int(plan.vec_a), int(plan.vec_b), plan.n_split, stream)
    if err != 0:
        raise RuntimeError(f"invariant_matmul launch failed: cudaError {err}")
    return out


def _router_fwd(x, w):
    if x.device.type != "cuda":
        return router_logits_ref(x, w)
    d, e = w.shape
    x2 = x.reshape(-1, d)
    out = _contract_cuda(x2[None], w[None])
    router_logits.launches += 1
    return out.reshape(*x.shape[:-1], e)


class _RouterLogits(torch.autograd.Function):
    """The kernel forward; the backward is the plain products."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _router_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w.t())
        if ctx.needs_input_grad[1]:
            d, e = w.shape
            dw = torch.matmul(x.reshape(-1, d).t(), g.reshape(-1, e))
        return dx, dw


@kernel_op("router_logits")
def router_logits(x, w):
    """Router logits x·w in f32: x (..., d), w (d, e) -> (..., e), every
    row summed in the kernel's fixed order (one weight matrix shared by
    all rows). Differentiable in x and w. CUDA tensors launch the kernel
    or raise; any other (CPU, meta) runs ``router_logits_ref``."""
    _router_shapes(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RouterLogits.apply(x, w)
    return _router_fwd(x, w)


router_logits.launches = 0


@kernel_op("batched_contract")
def batched_contract(a, b):
    """(n, p, k) x (n, k, q) -> (n, p, q) in f32, each matrix's every
    element summed in the kernel's fixed order. Views of any strides
    (a transposed key view) are read in place. No gradient: for calls
    that need none (serving). CUDA tensors launch the kernel or raise;
    any other (CPU, meta) runs ``batched_contract_ref``."""
    _contract_shapes(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise ValueError("batched_contract has no backward: call it on "
                         "operands that need no gradient")
    if a.device.type != "cuda":
        return batched_contract_ref(a, b)
    out = _contract_cuda(a, b)
    batched_contract.launches += 1
    return out


batched_contract.launches = 0
