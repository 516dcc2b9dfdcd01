"""The bf16 attention backward's tensor-core schedule
(``csrc/fa_bwd_hopper.cuh``), replayed on the CPU in float32 torch and
held against ``jax.vjp`` of the reference's
``repro.kernels.ref.attention_ref`` on the same numpy-seeded bf16 inputs
and output gradient.

The replay is the kernel's two passes as the card runs them, with the
CTA tiles read from the header's launch lines: the Δ pass's rows padded
to 64-row tiles (Δ = 0 and lse = +inf past Sq); the key-tile pass over
CTAs of 128 keys (64 above head_dim 64), 64 a warpgroup, streaming the
group's 64-row query tiles from the CTA's live range and skipping the
tiles outside the warpgroup's; the query-tile pass over CTAs of 192 rows
(128 above head_dim 64) and the forward's live 64-key tiles, a warpgroup
skipping the tiles outside its rows' reach; masks only on the tiles that
cross the diagonal, the window's edge or Skv (keys past Skv read as
zeros, as TMA fills them); the scale after the product, in log2 units; P
and dS rounded once to bf16 before their products; dq, dk and dv rounded
once at the store. Its gradients stay within the card's 1e-2 relative
Frobenius limit (``chip_smoke.py``'s ``FA_BWD_REL``) at llama3.2-1b's
heads, D 120 and 128 with a window, a soft cap, non-causal cross
attention with Skv ≠ Sq off the tile, ``q_offset`` with Skv off the
tile, rows with no live key (whose dq is exactly 0) and GQA groups of 4
and 8. Without the roundings the same schedule gives the reference's
gradients within 1e-5: the tiles it skips and leaves unmasked hold no
live pair.

    PYTHONPATH=src python -m pytest -q tests/test_torch_attention_bwd_tc.py
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as kref

LOG2E = 1.4426950408889634
T = 64                   # rows a warpgroup owns; rows of a streamed tile
# the card's limit on dq, dk and dv (chip_smoke.py's FA_BWD_REL["bfloat16"])
BWD_REL = 1e-2
EXACT_REL = 1e-5

# B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, cap
CASES = {
    "llama_heads": (1, 32, 8, 512, 512, 64, True, None, 0, None),
    "d120_window": (1, 8, 2, 400, 400, 120, True, 100, 0, None),
    "d128_window": (1, 4, 1, 300, 300, 128, True, 77, 0, None),
    "soft_cap": (1, 8, 2, 256, 256, 64, True, None, 0, 5.0),
    "cross_non_causal": (1, 4, 4, 200, 333, 64, False, None, 0, None),
    "q_offset": (2, 4, 2, 70, 333, 64, True, None, 263, None),
    "masked_rows": (1, 4, 2, 40, 37, 64, True, 3, 33, None),
    "gqa_4": (1, 8, 2, 320, 320, 64, True, None, 0, None),
    "gqa_8": (1, 8, 1, 300, 300, 128, True, None, 0, None),
}


HEADER = (pathlib.Path(__file__).resolve().parents[1] / "src" /
          "repro_torch" / "kernels" / "csrc" / "fa_bwd_hopper.cuh")


def _launch_tiles():
    """The header's launch lines, ``launch_cfg<D_PAD, KNWG, KNST, QNWG,
    QNST>(...)``, as {D_PAD: (keys a key-pass CTA, query rows a
    query-pass CTA)}: the tiles the card runs, so that a retune of the
    header is what the replay replays."""
    calls = re.findall(
        r"return launch_cfg<(\d+), (\d+), \d+, (\d+), \d+>\(",
        HEADER.read_text())
    tiles = {int(d): (T * int(k), T * int(q)) for d, k, q in calls}
    assert sorted(tiles) == [64, 128], calls
    return tiles


def _tiles(D):
    """``csrc/fa_bwd_hopper.cuh``'s CTA tiles by head_dim: (keys a
    key-pass CTA, query rows a query-pass CTA)."""
    return _launch_tiles()[64 if D <= 64 else 128]


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    """bf16-valued float32 numpy q, k, v and dO."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
                      (B, Hq, Sq, D))]
    return [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]


def _reference_vjp(q, k, v, g, causal, window, q_offset, cap):
    """(dq, dk, dv) of the reference's attention_ref through ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ref import attention_ref

    def f(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, logit_soft_cap=cap)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _pad_rows(t, n):
    """``t [B, H, S, D]`` with zero rows up to n (TMA's fill past S)."""
    B, H, S, D = t.shape
    return torch.cat([t.float(), torch.zeros(B, H, max(0, n - S), D)], 2)


def _scores(s, scale, scale_log2, cap):
    """The score in log2 units, scaled after the product (capped under
    the cap), and dt = 1 − tanh² (None without the cap)."""
    if cap is None:
        return s * scale_log2, None
    t = torch.tanh(s * scale / cap)
    return t * cap * LOG2E, 1.0 - t * t


def _live(kpos, qpos, Skv, causal, window):
    live = kpos < Skv
    if causal:
        live = live & (kpos <= qpos)
    if window is not None:
        live = live & (kpos > qpos - window)
    return live


def _bwd_schedule_tc(q, k, v, o, lse, do, causal, window, q_offset, cap,
                     rounding=True):
    """The bf16 kernels' two passes in float32 torch → (dq, dk, dv):
    bf16 when ``rounding`` (P and dS rounded before their products, the
    outputs at the store), else float32 with no rounding."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    has_window = window is not None and window <= q_offset + Sq - 1
    win = window if has_window else None
    scale = float(np.float32(kref.attention_scale(D)))
    scale_log2 = float(np.float32(scale) * np.float32(LOG2E))
    bkey, bq = _tiles(D)
    rnd = (lambda x: x.bfloat16().float()) if rounding else (lambda x: x)
    # the Δ pass: rows padded to whole tiles, Δ = 0 and lse2 = +inf there
    sq_pad = -(-Sq // T) * T
    delta = torch.zeros(B, Hq, sq_pad)
    delta[:, :, :Sq] = (do.float() * o.float()).sum(-1)
    lse2 = torch.full((B, Hq, sq_pad), float("inf"))
    lse2[:, :, :Sq] = lse * np.float32(LOG2E)
    rows = -(-Sq // bq) * bq + T
    keys = -(-Skv // bkey) * bkey + T
    qx, dox = _pad_rows(q, rows), _pad_rows(do, rows)
    kx, vx = _pad_rows(k, keys), _pad_rows(v, keys)

    # key-tile pass: the group's heads summed inside the CTA
    qg, dog = (t.view(B, Hkv, G, rows, D) for t in (qx, dox))
    lg, dg = (t.view(B, Hkv, G, sq_pad) for t in (lse2, delta))
    dk = torch.zeros(B, Hkv, keys, D)
    dv = torch.zeros(B, Hkv, keys, D)
    for k0 in range(0, Skv, bkey):
        q_lo = k0 - q_offset if causal and k0 > q_offset else 0
        q_hi = Sq
        if has_window:
            q_hi = min(q_hi, min(k0 + bkey, Skv) - 1 + window - q_offset)
        if q_hi <= q_lo:
            continue
        tiles = range(q_lo // T, -(-q_hi // T))
        for kw0 in range(k0, k0 + bkey, T):
            wq_lo = max(0, kw0 - q_offset) if causal else 0
            wq_hi = Sq if kw0 < Skv else 0
            if has_window:
                wq_hi = min(wq_hi, min(kw0 + T, Skv) - 1 + window - q_offset)
            kk, vv = kx[:, :, kw0:kw0 + T], vx[:, :, kw0:kw0 + T]
            kpos = torch.arange(kw0, kw0 + T)[:, None]
            for g in range(G):
                for qt in tiles:
                    q0 = qt * T
                    if not (q0 + T > wq_lo and q0 < wq_hi):
                        continue
                    qq, dd = qg[:, :, g, q0:q0 + T], dog[:, :, g, q0:q0 + T]
                    x, dt = _scores(kk @ qq.transpose(-1, -2), scale,
                                    scale_log2, cap)
                    dpt = vv @ dd.transpose(-1, -2)
                    masked = ((causal and kw0 + T - 1 > q_offset + q0) or
                              (has_window and
                               kw0 <= q_offset + q0 + T - 1 - window) or
                              kw0 + T > Skv)
                    if masked:
                        qpos = q_offset + torch.arange(q0, q0 + T)[None]
                        x = torch.where(_live(kpos, qpos, Skv, causal, win),
                                        x, float("-inf"))
                    p = torch.exp2(x - lg[:, :, g, None, q0:q0 + T])
                    dpt = dpt - dg[:, :, g, None, q0:q0 + T]
                    if dt is not None:
                        dpt = dpt * dt
                    dv[:, :, kw0:kw0 + T] += rnd(p) @ dd
                    dk[:, :, kw0:kw0 + T] += rnd(p * dpt) @ qq

    # query-tile pass: the forward's live key tiles, per warpgroup's reach
    kr, vr = (t.repeat_interleave(G, 1) for t in (kx, vx))
    dq = torch.zeros(B, Hq, rows, D)
    for q0 in range(0, Sq, bq):
        k_lo, k_hi = 0, Skv
        if has_window and q_offset + q0 - window + 1 > 0:
            k_lo = (q_offset + q0 - window + 1) // T * T
        if causal:
            k_hi = min(q_offset + q0 + bq, Skv)
        n_tiles = max(0, -(-(k_hi - k_lo) // T))
        for g0 in range(q0, min(q0 + bq, Sq), T):
            first, last = q_offset + g0, q_offset + g0 + T - 1
            it_lo, it_hi = 0, n_tiles
            if has_window and first - window + 1 - k_lo > 0:
                it_lo = min(n_tiles, (first - window + 1 - k_lo) // T)
            if causal:
                it_hi = (min(n_tiles, (last - k_lo) // T + 1)
                         if last >= k_lo else 0)
            qq, dd = qx[:, :, g0:g0 + T], dox[:, :, g0:g0 + T]
            l, dl = lse2[:, :, g0:g0 + T, None], delta[:, :, g0:g0 + T, None]
            qpos = (q_offset + torch.arange(g0, g0 + T))[:, None]
            acc = torch.zeros(B, Hq, T, D)
            for it in range(it_lo, max(it_hi, it_lo)):
                kt0 = k_lo + it * T
                kk, vv = kr[:, :, kt0:kt0 + T], vr[:, :, kt0:kt0 + T]
                x, dt = _scores(qq @ kk.transpose(-1, -2), scale, scale_log2,
                                cap)
                dp = dd @ vv.transpose(-1, -2) - dl
                if dt is not None:
                    dp = dp * dt
                if ((causal and kt0 + T - 1 > first) or
                        (has_window and kt0 <= last - window) or
                        kt0 + T > Skv):
                    kpos = torch.arange(kt0, kt0 + T)[None]
                    x = torch.where(_live(kpos, qpos, Skv, causal, win), x,
                                    float("-inf"))
                p = torch.exp2(x - l)
                acc += rnd(p * dp) @ kk
            dq[:, :, g0:g0 + T] = acc
    out = (dq[:, :, :Sq] * scale, dk[:, :, :Skv] * scale, dv[:, :, :Skv])
    return tuple(t.bfloat16() for t in out) if rounding else out


def _run(case, rounding):
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = CASES[case]
    q, k, v, g = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv + D)
    want = _reference_vjp(q, k, v, g, causal, window, qo, cap)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = kref.attention_chunked(tq, tk, tv, causal=causal, window=window,
                                    q_offset=qo, logit_soft_cap=cap,
                                    return_lse=True)
    if rounding:   # the forward kernel's output, and dO, are bf16
        o = o.bfloat16()
    got = _bwd_schedule_tc(tq, tk, tv, o, lse, tg, causal, window, qo, cap,
                           rounding=rounding)
    return got, want


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_tc_schedule_replay(case):
    """The bf16 kernels' schedule and roundings keep dq, dk and dv within
    the card's 1e-2 of the reference's gradients."""
    got, want = _run(case, rounding=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        assert _rel(a.float(), b) <= BWD_REL, (case, name, _rel(a.float(), b))


@pytest.mark.parametrize("case", ["llama_heads", "d120_window", "q_offset",
                                  "masked_rows", "cross_non_causal"])
def test_bwd_tc_schedule_exact_without_rounding(case):
    """The same schedule with no rounding gives the reference's gradients
    within float32 error: the tiles it skips and the tiles it leaves
    unmasked hold no live pair."""
    got, want = _run(case, rounding=False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) <= EXACT_REL, (case, name, _rel(a, b))


def test_bwd_tc_rows_without_keys_get_zero_dq():
    """Rows with no live key (lse = +inf) get P = 0 on every tile, so
    their dq is exactly 0, as the reference's."""
    B, Hq, Hkv, Sq, Skv, D, causal, window, qo, cap = CASES["masked_rows"]
    got, want = _run("masked_rows", rounding=True)
    # queries at 39 and 40 see no key below 37 within a window of 3
    assert bool((got[0][:, :, 6:] == 0).all())
    assert not np.abs(want[0][:, :, 6:]).any()
    assert float(got[0][:, :, :6].float().abs().max()) > 0


def test_bwd_wrapper_routes_and_strides(monkeypatch):
    """``ops.attention_bwd``'s launch on stand-in tensors (the wrapper
    routed to the kernel, the launch recorded): bf16 at head_dim ≤ 128
    takes the tensor-core route and passes q, k, v and dO as they lie (a
    transposed view's own pointer and strides, no copy; a row stride TMA
    cannot step is copied once), with the lse scratch; float32 and bf16
    at head_dim 256 take the SIMT route on contiguous inputs."""
    from repro_torch.kernels import ops
    calls = []
    monkeypatch.setattr(ops, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, dev, *args: calls.append(args))
    ops.reset_launch_counts()

    def run(dtype, D, Hq=4, Hkv=2, S=70):
        q, do = (torch.randn(1, S, Hq, D).to(dtype).transpose(1, 2)
                 for _ in range(2))
        k, v = (torch.randn(1, S, Hkv, D).to(dtype).transpose(1, 2)
                for _ in range(2))
        o = torch.randn(1, Hq, S, D).to(dtype)
        lse = torch.randn(1, Hq, S)
        dq, dk, dv = ops.attention_bwd(q, k, v, o, lse, do)
        assert all(t.is_contiguous() and t.dtype == dtype
                   for t in (dq, dk, dv))
        return (q, k, v, do), calls[-1]

    (q, k, v, do), args = run(torch.bfloat16, 64)
    assert args[40] == ops.BWD_ROUTE_CODES["wgmma"] == 1 and args[39] == 1
    assert [args[i] for i in (0, 1, 2, 4)] == [t.data_ptr()
                                               for t in (q, k, v, do)]
    assert list(args[11:20]) == [*q.stride()[:3], *k.stride()[:3],
                                 *v.stride()[:3]]
    assert list(args[23:26]) == list(do.stride()[:3])
    assert args[7] is not None
    (q, *_), args = run(torch.bfloat16, 36)   # 72-byte rows: copied once
    assert args[40] == 1 and args[0] != q.data_ptr() and args[13] == 40
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 256)):
        (q, *_), args = run(dtype, D)
        assert args[40] == ops.BWD_ROUTE_CODES["simt"] == 0
        assert args[7] is None and args[0] != q.data_ptr()
        assert list(args[11:14]) == [4 * 70 * D, 70 * D, D]
    assert ops.BWD_ROUTES == {"wgmma": 2, "simt": 2}
    assert ops.attention_bwd_route(torch.bfloat16, 128) == "wgmma"
    assert ops.attention_bwd_route(torch.float32, 128) == "simt"
