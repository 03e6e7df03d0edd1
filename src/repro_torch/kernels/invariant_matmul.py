"""Fixed-order f32 contractions: the CUDA kernel's wrappers and their
plain versions.

The kernel (``csrc/invariant_matmul.cu``, written for Hopper, built
with ``nvcc`` at first use and called through ctypes) replaces no Pallas
kernel. It computes f32 products that the reference leaves to XLA, in an
order that does not depend on the batch: every output element is summed
over k in 32-wide tiles taken in index order, one k a warp lane, and the
lanes' sums added by a fixed butterfly. So row i of an M-row launch, or
matrix i of an n-matrix launch, equals a 1-row or 1-matrix launch
bitwise, whatever M or n (rule 2 of the port). cuBLAS picks its f32
kernel, and with it the order of the sums, by the row and batch counts,
and the card's ``serve.telemetry.batch_variance_probe`` read ~1e-2 on
the sparse archs where the reference requires < 1e-5.

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
does not build or launch raises.
``router_logits.launches`` and ``batched_contract.launches`` count
launches (never plain runs), so a caller can show that a run went
through the kernel.
"""
from __future__ import annotations

import ctypes

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


def _launcher():
    from .build import load

    fn = load("invariant_matmul").invariant_contract_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 3 + [i] * 4 + [ll] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _contract_cuda(a, b):
    """Launch the kernel on (n, p, k) x (n, k, q) f32 views of any
    strides; returns a contiguous (n, p, q) f32 tensor."""
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    n, p, k = a.shape
    q = b.shape[2]
    out = torch.empty((n, p, q), dtype=torch.float32, device=a.device)
    fn = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, p, k, q,
                 *a.stride(), *b.stride(), stream)
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
