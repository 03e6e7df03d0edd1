"""The port's paged decode attention against the JAX package: the plain
version (what the wrapper runs on CPU tensors) against the JAX Pallas
kernel in interpret mode and against the JAX gather oracle, across GQA
widths, sliding windows, ragged tables with null blocks, inactive rows
and subdivided pool blocks, and over several of the kernel's 128-key
splits with causal ends on split boundaries (f32, atol 1e-5); the tile
and split policies; row independence; and, on a GPU, the CUDA kernel and
its no-fallback rule.

The JAX reference is imported by the ``jx`` fixture, so that the file
also collects on a GPU machine without jax, where the ``cuda``-marked
tests (which need no jax) run."""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import (
    paged_decode_attend,
    paged_decode_attend_ref,
)
from repro_torch.kernels.tuning import (
    KernelConfig,
    paged_config,
    paged_split_tiles,
)

ATOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import tuning
    from repro.kernels.paged_attention_kernels import paged_decode_attend
    from repro.layers.attention import _attend, _paged_view, make_mask

    return types.SimpleNamespace(
        jnp=jnp, paged_decode_attend=paged_decode_attend,
        KernelConfig=tuning.KernelConfig, paged_config=tuning.paged_config,
        attend=_attend, paged_view=_paged_view, make_mask=make_mask)


def _case(seed, groups, heads, block_size, row_lens, blocks_per_row,
          d=16, hole=False):
    """numpy inputs: random pool, ragged tables with physical ids handed
    out top-down (not in logical order), rows with len < 0 inactive, and
    optionally a null-block hole in row 0's table."""
    rng = np.random.RandomState(seed)
    num_blocks = len(row_lens) * blocks_per_row + 1
    k = rng.randn(num_blocks, block_size, groups, d).astype(np.float32)
    v = rng.randn(num_blocks, block_size, groups, d).astype(np.float32)
    q = rng.randn(len(row_lens), heads, d).astype(np.float32)
    pos = np.full((num_blocks, block_size), -1, np.int32)
    tables = np.zeros((len(row_lens), blocks_per_row), np.int32)
    nxt = num_blocks - 1
    for r, ln in enumerate(row_lens):
        for lb in range(-(-ln // block_size) if ln > 0 else 0):
            if hole and r == 0 and lb == 1:
                continue
            tables[r, lb] = nxt
            for off in range(block_size):
                if lb * block_size + off < ln:
                    pos[nxt, off] = lb * block_size + off
            nxt -= 1
    qpos = np.asarray([ln - 1 if ln > 0 else -1 for ln in row_lens],
                      np.int32)
    return q, k, v, pos, tables, qpos


def _port(arrs, **kw):
    return paged_decode_attend(*(torch.from_numpy(a) for a in arrs),
                               **kw).numpy()


def _jax_gather(jx, arrs, window, is_global):
    q, k, v, pos, tables, qpos = (jx.jnp.asarray(a) for a in arrs)
    gathered, kpos = jx.paged_view({"k": k, "v": v, "pos": pos}, tables)
    mask = jx.make_mask(qpos[:, None], kpos, True, window, is_global)
    return np.asarray(jx.attend(q[:, None], gathered["k"], gathered["v"],
                                mask)[:, 0])


CASES = [
    # (groups, heads, window, is_global, block_size, paged_block_kv)
    (2, 4, None, True, 8, 0),     # GQA 2:1
    (1, 4, None, True, 8, 0),     # MQA-style single kv head
    (2, 6, None, True, 8, 0),     # rep 3: not a power of two
    (2, 4, 6, False, 8, 0),       # sliding-window local layer
    (2, 4, 6, True, 8, 0),        # window config on a GLOBAL layer
    (2, 4, None, True, 6, 0),     # non-power-of-two block size
    (4, 4, None, True, 16, 0),    # MHA (rep 1)
    (2, 4, None, True, 16, 4),    # pool blocks subdivided into 4 tiles
]


@pytest.mark.parametrize("groups,heads,window,is_global,block_size,bkv",
                         CASES)
def test_plain_matches_jax_kernel_and_gather(jx, groups, heads, window,
                                             is_global, block_size, bkv):
    row_lens = [3 * block_size + 1, 2, block_size, -1]
    arrs = _case(0, groups, heads, block_size, row_lens, 4,
                 hole=window is None)
    kw = dict(causal=True, window=window, is_global=is_global)
    out = _port(arrs, cfg=KernelConfig(paged_block_kv=bkv), **kw)
    ref_kernel = np.asarray(jx.paged_decode_attend(
        *(jx.jnp.asarray(a) for a in arrs),
        cfg=jx.KernelConfig(paged_block_kv=bkv, interpret=True), **kw))
    np.testing.assert_allclose(out, ref_kernel, rtol=0, atol=ATOL)
    active = arrs[-1] >= 0
    ref_gather = _jax_gather(jx, arrs, window, is_global)
    np.testing.assert_allclose(out[active], ref_gather[active], rtol=0,
                               atol=ATOL)
    # inactive rows: every key masked -> defined zeros, never NaN
    assert np.isfinite(out).all() and (out[~active] == 0).all()


# (window, is_global) over rows of the split-KV kernel's 128-key splits
# (block 64: one tile a block, two tiles a split): four splits with a
# ragged last one (450), causal ends on a split's last key (256) and on
# the next split's first (257), a row shorter than one split (40), an
# inactive row
SPLIT_ROWS = [450, 256, 257, 40, -1]


@pytest.mark.parametrize("window,is_global", [(None, True), (100, False),
                                              (100, True)])
def test_plain_splits_match_jax_kernel_and_gather(jx, window, is_global):
    assert paged_split_tiles(paged_config(64).paged_block_kv) == 2
    arrs = _case(9, 2, 4, 64, SPLIT_ROWS, 8, hole=window is None)
    kw = dict(causal=True, window=window, is_global=is_global)
    out = _port(arrs, **kw)
    ref_kernel = np.asarray(jx.paged_decode_attend(
        *(jx.jnp.asarray(a) for a in arrs),
        cfg=jx.KernelConfig(interpret=True), **kw))
    np.testing.assert_allclose(out, ref_kernel, rtol=0, atol=ATOL)
    active = arrs[-1] >= 0
    ref_gather = _jax_gather(jx, arrs, window, is_global)
    np.testing.assert_allclose(out[active], ref_gather[active], rtol=0,
                               atol=ATOL)
    assert np.isfinite(out).all() and (out[~active] == 0).all()


def test_split_policy_depends_only_on_the_pool_tiling():
    """A split is whole tiles of paged_block_kv keys, up to 128 keys (at
    least one tile), from the pool's tiling alone; so a row's output is
    bitwise the same whatever the batch and the other rows' lengths."""
    assert ([paged_split_tiles(b) for b in (16, 8, 6, 64, 96, 128, 256)]
            == [8, 16, 21, 2, 1, 1, 1])
    arrs = [torch.from_numpy(a)
            for a in _case(5, 2, 4, 16, [300, 40, 129, -1, 7], 24)]
    q, k, v, pos, tables, qpos = arrs
    full = paged_decode_attend_ref(*arrs)
    for rows in ([0], [1], [2, 0], [4, 1, 3], [3]):
        sub = paged_decode_attend_ref(q[rows], k, v, pos, tables[rows],
                                      qpos[rows])
        assert torch.equal(sub, full[rows]), rows


@pytest.mark.parametrize("block_size", [16, 256, 192, 250])
def test_paged_config_matches_jax(jx, block_size):
    assert (paged_config(block_size).paged_block_kv
            == jx.paged_config(block_size).paged_block_kv)
    base = KernelConfig(paged_block_kv=2)
    assert (paged_config(block_size, base).paged_block_kv
            == jx.paged_config(block_size, jx.KernelConfig(
                paged_block_kv=2)).paged_block_kv)


def test_rows_are_independent_bitwise():
    """Row i of a batched call equals a batch-1 call of row i, bitwise
    (the per-row invariant the CUDA kernel keeps by giving each row its
    own CTAs)."""
    arrs = [torch.from_numpy(a)
            for a in _case(3, 2, 14, 16, [70, 5, -1, 33, 16], 6, d=64)]
    q, k, v, pos, tables, qpos = arrs
    batched = paged_decode_attend(*arrs)
    for r in range(q.shape[0]):
        one = paged_decode_attend(q[r:r + 1], k, v, pos, tables[r:r + 1],
                                  qpos[r:r + 1])
        assert torch.equal(one[0], batched[r]), r


def test_cpu_tensors_run_the_plain_version_without_launching():
    arrs = [torch.from_numpy(a) for a in _case(1, 2, 4, 8, [9, 3], 2)]
    before = paged_decode_attend.launches
    out = paged_decode_attend(*arrs)
    assert paged_decode_attend.launches == before
    assert torch.equal(out, paged_decode_attend_ref(*arrs))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda")


def _cuda_case(dtype):
    """q, k, v in ``dtype``; positions and tables int32; on the card."""
    arrs = _case(2, 2, 14, 16, [600, 37, -1, 16], 40, d=64)
    return [torch.from_numpy(a).cuda().to(dtype) if i < 3
            else torch.from_numpy(a).cuda() for i, a in enumerate(arrs)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0**-7)])
def test_cuda_kernel_matches_plain_version(cuda, dtype, rtol):
    """f32 within 1e-5; bf16 within one bf16 step of the output (both
    sides agree in f32, then round)."""
    arrs = _cuda_case(dtype)
    before = paged_decode_attend.launches
    out = paged_decode_attend(*arrs)
    torch.cuda.synchronize()
    assert paged_decode_attend.launches == before + 1
    ref = paged_decode_attend_ref(*arrs)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-5,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 0.0),
                                        (torch.bfloat16, 2.0**-7)])
@pytest.mark.parametrize("bkv", [0, 8])
def test_cuda_split_edges_match_plain_version(cuda, dtype, rtol, bkv):
    """Causal ends on 128-key split boundaries (a split's last key, the
    next one's first), one short of the table, a single key, an inactive
    row; batched == batch-1 bitwise."""
    arrs = _case(4, 2, 14, 16, [256, 128, 129, 1, 2047, -1, 127], 128,
                 d=64)
    arrs = [torch.from_numpy(a).cuda().to(dtype) if i < 3
            else torch.from_numpy(a).cuda() for i, a in enumerate(arrs)]
    cfg = KernelConfig(paged_block_kv=bkv)
    out = paged_decode_attend(*arrs, cfg=cfg)
    torch.cuda.synchronize()
    ref = paged_decode_attend_ref(*arrs, cfg=cfg)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-5,
                               rtol=rtol)
    assert (out[5] == 0).all()
    q, k, v, pos, tables, qpos = arrs
    for r in range(q.shape[0]):
        one = paged_decode_attend(q[r:r + 1], k, v, pos, tables[r:r + 1],
                                  qpos[r:r + 1], cfg=cfg)
        assert torch.equal(one[0], out[r]), r


@pytest.mark.cuda
def test_cuda_malformed_operands_raise_never_fall_back(cuda):
    """No fallback: a malformed pool raises instead of quietly returning
    the plain version's result, and launches nothing."""
    q, k, v, pos, tables, qpos = _cuda_case(torch.bfloat16)
    before = paged_decode_attend.launches
    with pytest.raises(TypeError):
        paged_decode_attend(q, k.half(), v.half(), pos, tables, qpos)
    strided = k.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attend(q, strided, v, pos, tables, qpos)
    # head dim of 60 bf16 = 120 bytes: not a whole number of 16-byte loads
    q60, k60, v60 = (t[..., :60].contiguous() for t in (q, k, v))
    with pytest.raises(ValueError, match="16 bytes"):
        paged_decode_attend(q60, k60, v60, pos, tables, qpos)
    # a contiguous pool that starts 2 bytes past a 16-byte boundary
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype,
                          device=k.device)[1:].view(k.shape)
    shifted.copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        paged_decode_attend(q, shifted, v, pos, tables, qpos)
    assert paged_decode_attend.launches == before
