"""The port's attention: the plain versions and the ``flash_attention``
kernel.

On the CPU: ``ref.attention_ref``, ``attention_chunked`` and
``decode_attention_ref`` against the reference's on the same numpy-seeded
inputs (``tests/test_kernels.py``'s cases, plus windowed-band, ragged and
``q_offset`` cases), float32 within 2e-5 (bfloat16 within 2e-2); the
port's ``ops.attention`` against the reference's Pallas kernel in
interpret mode for the causal cases (2e-3 in float32, 2e-2 in bfloat16,
the reference's own tolerances); the reference's non-causal padding
fault, which the port does not share; and the kernel's tile schedule
replayed in float32 torch against ``attention_ref`` (1e-5). The bf16
tensor-core kernel's schedule replay and its planted fault are in
``tests/test_torch_attention_fwd_tc.py``.

On the card (marker ``cuda``, skipped elsewhere): the kernel against
``attention_ref`` on the same CUDA tensors, over the same tolerances, at
every dtype, window, soft cap, ``q_offset``, ragged length, head_dim (32
to 256) and stride the models give it. This file imports JAX only inside
the reference comparisons, so the card tests run where JAX is missing:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

F32, BF16 = "float32", "bfloat16"
TORCH_DT = {F32: torch.float32, BF16: torch.bfloat16}

# tests/test_kernels.py's CASES: B, Hq, Hkv, S, D, window, causal, cap, dtype
CASES = [
    (1, 4, 4, 256, 64, None, True, None, F32),
    (2, 4, 2, 256, 64, None, True, None, F32),
    (2, 8, 2, 384, 32, None, True, None, BF16),
    (1, 4, 1, 256, 128, None, False, None, F32),
    (2, 4, 2, 256, 64, 64, True, None, F32),
    (1, 2, 2, 512, 64, 128, True, None, F32),
    (1, 4, 4, 256, 64, None, True, 30.0, F32),
]
# windowed band (a window that is not a multiple of the chunk), ragged
# lengths, q_offset (a decode-like query block against a longer cache)
EXTRA = [
    # B, Hq, Hkv, Sq, Skv, D, window, causal, cap, q_offset, dtype
    (1, 4, 2, 200, 200, 32, 100, True, None, 0, F32),
    (2, 2, 1, 200, 200, 32, None, False, None, 0, F32),
    (1, 4, 2, 77, 300, 16, None, True, 5.0, 223, F32),
    (1, 2, 2, 130, 130, 24, 7, True, None, 0, F32),
]


def _jax():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jops, jref


def _qkv(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _all_cases():
    for B, Hq, Hkv, S, D, window, causal, cap, dt in CASES:
        yield (B, Hq, Hkv, S, S, D, window, causal, cap, 0, dt)
    yield from EXTRA


ALL = list(_all_cases())


def _tol(dt):
    return 2e-2 if dt == BF16 else 2e-5


def _as(arrays, dt, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DT[dt])
            for a in arrays]


@pytest.mark.parametrize("fn", ["attention_ref", "attention_chunked"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window,causal,cap,q_offset,dt",
                         ALL)
def test_plain_attention_matches_reference(fn, B, Hq, Hkv, Sq, Skv, D,
                                           window, causal, cap, q_offset,
                                           dt):
    jnp, _, jref = _jax()
    arrays = _qkv(B, Hq, Hkv, Sq, Skv, D, seed=B * 100 + Sq)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              logit_soft_cap=cap)
    if fn == "attention_chunked":
        kw["chunk"] = 128
    want = getattr(jref, fn)(*(jnp.asarray(a, dtype=dt) for a in arrays),
                             **kw)
    got = getattr(kref, fn)(*_as(arrays, dt), **kw)
    assert got.dtype == TORCH_DT[dt] and got.shape == (B, Hq, Sq, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=_tol(dt))


@pytest.mark.parametrize("length,window,cap", [(77, None, None),
                                               (128, None, None),
                                               (40, 16, None),
                                               (1, None, 10.0),
                                               (100, 130, None)])
def test_decode_attention_ref_matches_reference(length, window, cap):
    jnp, _, jref = _jax()
    q, kc, vc = _qkv(2, 4, 2, 1, 128, 32, seed=length)
    want = jref.decode_attention_ref(
        *map(jnp.asarray, (q, kc, vc)), jnp.asarray(length), window=window,
        logit_soft_cap=cap)
    got = kref.decode_attention_ref(*_as((q, kc, vc), F32), length,
                                    window=window, logit_soft_cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


CAUSAL = [c for c in CASES if c[6]]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,causal,cap,dt", CAUSAL)
def test_ops_attention_matches_pallas(B, Hq, Hkv, S, D, window, causal, cap,
                                      dt):
    """The port's wrapper on CPU tensors (the plain chunked version)
    against the reference's Pallas kernel in interpret mode."""
    jnp, jops, _ = _jax()
    arrays = _qkv(B, Hq, Hkv, S, S, D, seed=B * 100 + S)
    want = jops.attention(*(jnp.asarray(a, dtype=dt) for a in arrays),
                          causal=causal, window=window, soft_cap=cap,
                          impl="pallas")
    before = ops.launch_counts()["flash_attention"]
    got = ops.attention(*_as(arrays, dt), causal=causal, window=window,
                        soft_cap=cap)
    assert ops.launch_counts()["flash_attention"] == before
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2 if dt == BF16 else 2e-3)


def test_reference_pallas_padding_fault_not_in_port():
    """The reference's wrapper pads K/V to a multiple of block_k with zero
    keys that only the causal mask hides: non-causal at S = 200 its Pallas
    path strays from its oracle. The port takes Skv as it is."""
    jnp, jops, jref = _jax()
    arrays = _qkv(1, 2, 2, 200, 200, 32, seed=0)
    jq, jk, jv = map(jnp.asarray, arrays)
    pallas = np.asarray(jops.attention(jq, jk, jv, causal=False,
                                       impl="pallas"))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=False))
    assert np.abs(pallas - oracle).max() > 1e-2
    for impl in ("auto", "torch", "ref"):
        got = ops.attention(*_as(arrays, F32), causal=False, impl=impl)
        np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5)


def test_attention_wrapper_refuses_bad_operands():
    q, k, v = _as(_qkv(1, 4, 2, 8, 8, 16, seed=1), F32)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        ops.attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="one"):
        ops.attention(q, k, v[:, :, :4])
    with pytest.raises(ValueError, match="soft_cap"):
        ops.attention(q, k, v, soft_cap=0.0)


def test_plain_attention_keeps_gqa_and_strides():
    """GQA by reshape equals the explicit repeat, and a transposed view
    (the projections' layout) gives the contiguous tensor's answer."""
    q, k, v = _as(_qkv(2, 6, 2, 40, 40, 16, seed=2), F32)
    rep = [t.repeat_interleave(3, dim=1) for t in (k, v)]
    want = kref.attention_ref(q, *rep, window=9)
    np.testing.assert_allclose(kref.attention_ref(q, k, v, window=9).numpy(),
                               want.numpy(), atol=1e-6)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous()
    np.testing.assert_allclose(
        ops.attention(qt, k, v, window=9, chunk=16).numpy(), want.numpy(),
        atol=1e-6)


def _flash_schedule(q, k, v, causal, window, q_offset, cap, bq=64, bk=64):
    """``csrc/flash_attention.cu``'s schedule replayed in float32 torch: a
    64-query tile visits only the key tiles from its first row's first
    visible key (window) to its last row's causal limit, keeping the
    running max (from -1e30), denominator and accumulator; ``Skv`` masks
    keys past it; a window wider than every query's reach is dropped."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kx = k.float().repeat_interleave(Hq // Hkv, 1)
    vx = v.float().repeat_interleave(Hq // Hkv, 1)
    has_window = window is not None and window <= q_offset + Sq - 1
    out = torch.zeros(B, Hq, Sq, D)
    for q0 in range(0, Sq, bq):
        rows = torch.arange(q0, min(q0 + bq, Sq))
        qq = q[:, :, rows].float() * kref.attention_scale(D)
        m = torch.full((B, Hq, len(rows), 1), -1e30)
        l = torch.zeros(B, Hq, len(rows), 1)
        acc = torch.zeros(B, Hq, len(rows), D)
        k_lo, k_hi = 0, Skv
        if has_window:
            k_lo = max(0, (q_offset + q0 - window + 1) // bk * bk)
        if causal:
            k_hi = min(Skv, q_offset + q0 + bq)
        for k0 in range(k_lo, k_hi, bk):
            keys = torch.arange(k0, min(k0 + bk, Skv))
            s = qq @ kx[:, :, keys].transpose(-1, -2)
            if cap is not None:
                s = cap * torch.tanh(s / cap)
            qpos = (q_offset + rows)[:, None]
            live = torch.ones(len(rows), len(keys), dtype=torch.bool)
            if causal:
                live &= keys[None] <= qpos
            if has_window:
                live &= keys[None] > qpos - window
            s = torch.where(live, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(live, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vx[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / torch.clamp_min(l, 1e-30)
    return out


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window,causal,cap,q_offset", [
    c[:10] for c in EXTRA] + [
    (1, 2, 1, 150, 150, 16, 1, True, None, 0),
    (1, 2, 1, 70, 170, 8, 64, True, None, 100),
    (1, 2, 2, 150, 150, 16, 30, False, None, 0),
    (1, 2, 1, 100, 100, 8, 10 ** 9, True, None, 0),
    (1, 2, 1, 64, 0, 8, None, False, None, 0),
])
def test_flash_tile_schedule_replay(B, Hq, Hkv, Sq, Skv, D, window, causal,
                                    cap, q_offset):
    """The kernel's tile schedule and online softmax, replayed on the CPU,
    give ``attention_ref``'s answer: the schedule the card runs skips only
    dead tiles."""
    q, k, v = _as(_qkv(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv), F32)
    got = _flash_schedule(q, k, v, causal, window, q_offset, cap)
    want = kref.attention_ref(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, logit_soft_cap=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc "
                    "and run only on the card)")
    return torch.device("cuda")


CARD = ALL + [
    # llama3.2-1b's heads, gemma3-4b's local layer (head_dim 256, window),
    # danube's head_dim 120, starcoder2's 128 (Hq 36 over Hkv 4)
    (1, 32, 8, 1024, 1024, 64, None, True, None, 0, BF16),
    (1, 8, 4, 700, 700, 256, 200, True, None, 0, BF16),
    (1, 8, 2, 300, 300, 120, 64, True, None, 0, F32),
    (1, 36, 4, 129, 129, 128, None, True, None, 0, BF16),
    (2, 4, 2, 1, 513, 64, None, True, 30.0, 512, F32),
    (1, 2, 1, 64, 0, 32, None, False, None, 0, F32),
    # the bf16 tensor-core kernel: Sq and Skv off its 192-row and 128-key
    # tiles, a q_offset with and without a window, Hq / Hkv = 9
    # (starcoder2's 36 / 4), head_dim 120 and 256 (with a soft cap), a
    # head_dim off TMA's 16-byte rule (copied, padded), no keys at all
    (2, 4, 2, 300, 300, 64, None, True, None, 0, BF16),
    (1, 4, 2, 200, 350, 64, None, False, None, 0, BF16),
    (1, 4, 2, 333, 517, 64, None, True, None, 184, BF16),
    (1, 4, 2, 333, 517, 64, 100, True, None, 184, BF16),
    (1, 36, 4, 300, 300, 128, None, True, None, 0, BF16),
    (1, 8, 2, 300, 300, 120, 64, True, None, 0, BF16),
    (1, 8, 4, 333, 333, 256, None, True, 30.0, 0, BF16),
    (1, 4, 2, 100, 100, 36, None, True, None, 0, BF16),
    (1, 2, 1, 64, 0, 32, None, False, None, 0, BF16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window,causal,cap,q_offset,dt",
                         CARD)
def test_cuda_flash_attention_matches_plain(cuda, B, Hq, Hkv, Sq, Skv, D,
                                            window, causal, cap, q_offset,
                                            dt):
    q, k, v = _as(_qkv(B, Hq, Hkv, Sq, Skv, D, seed=Sq + D), dt, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = ops.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, soft_cap=cap, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + (Sq > 0)
    want = kref.attention_ref(q, k, v, logit_soft_cap=cap, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=2e-2 if dt == BF16 else 2e-3)


@pytest.mark.cuda
def test_cuda_flash_attention_reads_strided_views(cuda):
    """The projections' transposed views go in without a copy and give the
    contiguous tensors' bytes."""
    q, k, v = _as(_qkv(2, 8, 2, 300, 300, 64, seed=3), BF16, cuda)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    assert not views[0].is_contiguous()
    a = ops.attention(*views, window=50, impl="cuda")
    b = ops.attention(q, k, v, window=50, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _projection_views(B, S, H, D, dtype=torch.bfloat16, device="cpu"):
    """``[B, H, S, D]`` transposed views of a ``[B, S, H·D]`` projection,
    as ``models/attention.py`` makes them."""
    x = torch.randn(B, S, H * D, generator=torch.Generator().manual_seed(S))
    return x.to(device=device, dtype=dtype).view(B, S, H, D).transpose(1, 2)


def test_tma_ready_takes_projection_views():
    """llama3.2-1b's transposed projection views meet TMA's rule (base
    16-byte aligned, batch, head and sequence strides 16-byte multiples),
    so the bf16 kernel reads them uncopied; a view one element off, or a
    head_dim whose rows are not 16-byte multiples, does not, and its copy
    does."""
    q = _projection_views(1, 64, 32, 64)
    k = _projection_views(1, 64, 8, 64)
    assert not q.is_contiguous()
    assert ops.tma_ready(q) and ops.tma_ready(k)
    off = torch.empty(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    off.copy_(q)
    odd = _projection_views(1, 64, 4, 36)
    for t in (off, odd):
        assert not ops.tma_ready(t)
        c = ops._tma_copy(t)
        assert ops.tma_ready(c)
        assert torch.equal(c[..., :t.shape[-1]], t)
        assert not c[..., t.shape[-1]:].any()


@pytest.mark.cuda
def test_cuda_flash_attention_copies_only_misaligned_views(cuda, monkeypatch):
    """The projection views launch with no copy; an operand off TMA's
    rule is copied and gives the aligned operands' answer."""
    copies = []
    orig = ops._tma_copy
    monkeypatch.setattr(ops, "_tma_copy",
                        lambda t: copies.append(t.shape) or orig(t))
    q = _projection_views(1, 300, 32, 64, device=cuda)
    k = _projection_views(1, 300, 8, 64, device=cuda)
    v = _projection_views(1, 300, 8, 64, device=cuda)
    a = ops.attention(q, k, v, impl="cuda")
    assert copies == []
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    off = buf[1:].view(q.shape)
    off.copy_(q)
    b = ops.attention(off, k, v, impl="cuda")
    torch.cuda.synchronize()
    assert len(copies) == 1
    assert torch.equal(a, b)
    want = kref.attention_ref(q, k, v)
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2)


@pytest.mark.cuda
def test_cuda_attention_padding_fault_not_in_port(cuda):
    q, k, v = _as(_qkv(1, 2, 2, 200, 200, 32, seed=0), F32, cuda)
    got = ops.attention(q, k, v, causal=False, impl="cuda")
    want = kref.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_flash_attention_refuses(cuda):
    q = torch.zeros(1, 2, 8, 288, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(q, q, q, impl="cuda")
    q = torch.zeros(1, 2, 8, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or"):
        ops.attention(q, q, q, impl="cuda")
