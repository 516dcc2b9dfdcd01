"""The bf16 ``flash_attention`` kernel's tensor-core schedule
(``csrc/fa_hopper.cuh``) replayed on the CPU.

The replay in float32 torch (CTA tiles of 192 query rows, 128 above
head_dim 64; each warpgroup's live key tiles; masks only on the tiles that
cross the diagonal, the window's edge or ``Skv``; S scaled after the
product in log2 units; P entering P · V as bf16 ``P_hi + P_lo``) stays
within the 32k gate's relative Frobenius limit of ``attention_ref`` on the
same bf16 inputs, at ``tests/test_torch_attention.py``'s extra cases and
the models' head shapes; and the planted fault (P rounded once to bf16)
reads above it. Split from ``tests/test_torch_attention.py`` so that
``--dist loadfile`` can run it on another worker.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as kref
from test_torch_attention import BF16, EXTRA, _as, _qkv

# the 32k gate's relative Frobenius limit in bf16 (chip_smoke.py's
# ATTN_REL["bfloat16"])
BF16_REL = 1e-3
LOG2E = 1.4426950408889634


def _rel_frobenius(got, want):
    num = float((got.double() - want.double()).norm())
    den = float(want.double().norm())
    return num / den if den else num


def _tc_tiles(D):
    """``csrc/fa_hopper.cuh``'s tiles by head_dim: (query rows a CTA, keys
    a tile); 64 query rows a consumer warpgroup."""
    return (192 if D <= 64 else 128), 64


def _bf16_truncated(x):
    """float32 ``x`` with its low 16 bits cleared (exactly a bf16 value)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _flash_schedule_tc(q, k, v, causal, window, q_offset, cap, split=True):
    """The bf16 tensor-core kernel (``csrc/fa_hopper.cuh``) replayed in
    float32 torch: CTA tiles of 192 query rows (128 above head_dim 64) visit
    the key tiles from the window's first visible key of their first row to
    the causal limit of their last; each 64-row warpgroup skips the tiles
    wholly outside its rows' reach and masks only the tiles that cross the
    diagonal, the window's edge or ``Skv`` (keys past it read as zeros, as
    TMA fills them); S is scaled after the product, in log2 units; P enters
    the second product as bf16 ``P_hi + P_lo`` (``split``: P_hi truncated,
    P_lo = P - P_hi rounded) or rounded once to bf16. Returns bf16, as the
    kernel does."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    bq, bk = _tc_tiles(D)
    g = Hq // Hkv
    has_window = window is not None and window <= q_offset + Sq - 1
    scale = float(np.float32(kref.attention_scale(D)))
    scale_log2 = float(np.float32(scale) * np.float32(LOG2E))
    pad = bk + (-Skv % bk)                  # zero keys past Skv
    kx = torch.cat([k.float(), k.new_zeros(B, Hkv, pad, D).float()], 2)
    vx = torch.cat([v.float(), v.new_zeros(B, Hkv, pad, D).float()], 2)
    kx, vx = (t.repeat_interleave(g, 1) for t in (kx, vx))
    out = torch.zeros(B, Hq, Sq, D)
    for q0 in range(0, Sq, bq):
        k_lo, k_hi = 0, Skv
        if has_window and q_offset + q0 - window + 1 > 0:
            k_lo = (q_offset + q0 - window + 1) // bk * bk
        if causal:
            k_hi = min(q_offset + q0 + bq, Skv)
        n_tiles = max(0, -(-(k_hi - k_lo) // bk))
        for g0 in range(q0, min(q0 + bq, Sq), 64):
            rows = torch.arange(g0, min(g0 + 64, Sq))
            first, last = q_offset + g0, q_offset + g0 + 63
            it_lo, it_hi = 0, n_tiles
            if has_window and first - window + 1 - k_lo > 0:
                it_lo = min(n_tiles, (first - window + 1 - k_lo) // bk)
            if causal:
                it_hi = (min(n_tiles, (last - k_lo) // bk + 1)
                         if last >= k_lo else 0)
            qq = q[:, :, rows].float()
            qpos = (q_offset + rows)[:, None]
            m = torch.full((B, Hq, len(rows), 1), float("-inf"))
            l = torch.zeros(B, Hq, len(rows), 1)
            acc = torch.zeros(B, Hq, len(rows), D)
            for it in range(it_lo, max(it_hi, it_lo)):
                k0 = k_lo + it * bk
                keys = torch.arange(k0, k0 + bk)
                s = qq @ kx[:, :, k0:k0 + bk].transpose(-1, -2)
                if cap is not None:
                    t = torch.tanh(s * scale / cap) * cap * LOG2E
                else:
                    t = s * scale_log2
                if ((causal and k0 + bk - 1 > first) or
                        (has_window and k0 <= last - window) or
                        k0 + bk > Skv):
                    live = keys[None] < Skv
                    if causal:
                        live = live & (keys[None] <= qpos)
                    if has_window:
                        live = live & (keys[None] > qpos - window)
                    t = torch.where(live, t, float("-inf"))
                m_new = torch.maximum(m, t.amax(-1, keepdim=True))
                mu = torch.where(m_new == float("-inf"), 0.0, m_new)
                alpha = torch.exp2(m - mu)
                p = torch.exp2(t - mu)
                l = l * alpha + p.sum(-1, keepdim=True)
                vt = vx[:, :, k0:k0 + bk]
                if split:
                    p_hi = _bf16_truncated(p)
                    pv = p_hi @ vt + (p - p_hi).bfloat16().float() @ vt
                else:
                    pv = p.bfloat16().float() @ vt
                acc = acc * alpha + pv
                m = m_new
            out[:, :, rows] = torch.where(l > 0, acc / l, 0.0)
    return out.bfloat16()


# the replay's cases: the f32 schedule's, plus bf16 at llama3.2-1b's heads,
# gemma3-4b's local layer (head_dim 256; its 1024 window cut to 300 at
# S = 1,024, where 1024 would mask nothing) and danube's head_dim 120
TC_CASES = [c[:10] for c in EXTRA] + [
    (1, 2, 1, 150, 150, 16, 1, True, None, 0),
    (1, 2, 1, 70, 170, 8, 64, True, None, 100),
    (1, 2, 2, 150, 150, 16, 30, False, None, 0),
    (1, 2, 1, 100, 100, 8, 10 ** 9, True, None, 0),
    (1, 2, 1, 64, 0, 8, None, False, None, 0),
    (1, 32, 8, 1024, 1024, 64, None, True, None, 0),
    (1, 8, 4, 1024, 1024, 256, 300, True, None, 0),
    (1, 32, 8, 1024, 1024, 120, None, True, None, 0),
    (1, 4, 2, 333, 517, 64, 100, True, None, 184),
]
# the head shapes where the 32k gate reads: one rounding of P fails it
TC_SPLIT_CASES = TC_CASES[-4:-1]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window,causal,cap,q_offset",
                         TC_CASES)
def test_flash_tc_schedule_replay(B, Hq, Hkv, Sq, Skv, D, window, causal,
                                  cap, q_offset):
    """The bf16 kernel's schedule (128-row tiles, live ranges per
    warpgroup, unmasked inner tiles, scale after the product, split P),
    replayed on the CPU, stays within the 32k gate's relative Frobenius
    limit of ``attention_ref`` on the same bf16 inputs."""
    q, k, v = _as(_qkv(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv + D), BF16)
    got = _flash_schedule_tc(q, k, v, causal, window, q_offset, cap)
    want = kref.attention_ref(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, logit_soft_cap=cap)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    if not want.float().abs().max():
        assert not got.float().abs().max()
    else:
        assert _rel_frobenius(got, want) <= BF16_REL


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,window,causal,cap,q_offset",
                         TC_SPLIT_CASES)
def test_flash_tc_single_bf16_p_fails_the_gate(B, Hq, Hkv, Sq, Skv, D,
                                               window, causal, cap,
                                               q_offset):
    """Why the kernel splits P: on the same inputs, P rounded once to bf16
    before P · V reads above the limit that P_hi + P_lo keeps."""
    q, k, v = _as(_qkv(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv + D), BF16)
    want = kref.attention_ref(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, logit_soft_cap=cap)
    one = _flash_schedule_tc(q, k, v, causal, window, q_offset, cap,
                             split=False)
    two = _flash_schedule_tc(q, k, v, causal, window, q_offset, cap)
    assert _rel_frobenius(one, want) > BF16_REL
    assert _rel_frobenius(two, want) <= BF16_REL / 4
