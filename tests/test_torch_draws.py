"""The threefry draws' kernels and the stitch kernels' ``rng="device"``, on
the CPU.

``prng``'s draws launch one kernel each for a CUDA key
(``kernels/csrc/threefry_draw.cu`` through ``kernels/draw.py``); the
stitch wrappers take the wave's key in place of the slot bits under
``rng="device"`` and draw ``s0 = randint(key, (W,), 0, 2**30)`` in the
kernel. The card tests hold the kernels against the plain versions; here:

* a CPU key never reaches the kernel library, and ``impl="cuda"`` on one
  raises;
* ``draw.py``'s launches replayed through the kernels' C entry points
  written once in numpy ``uint32`` (threefry, each CTA's key rows and
  counters, randint's per-CTA split keys and its high stream dropped past
  a span of 2**16): equal to ``prng``'s plain draws, batched keys and
  broadcast ``fold_in`` data included;
* each stitch wrapper's device mode equal to its caller mode fed
  ``prng.randint(key, (W,), 0, 2**30)``, and to the reference's caller-mode
  Pallas kernels (interpret mode) fed ``jax.random.randint`` from the same
  key;
* the dense and loop waves and ``query_counts``, which now take the device
  mode, equal to the reference's answers byte for byte.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import WalkIndexConfig as JWalkIndexConfig
from repro.graph import generators as jgen
from repro.kernels import ops as jops
from repro.query import engine as jengine
from repro.query import index as jindex
from repro.query import scheduler as jsched
from repro_torch import convert, prng
from repro_torch.config import WalkIndexConfig
from repro_torch.graph import generators as tgen
from repro_torch.kernels import build, ops
from repro_torch.query import engine as tengine
from repro_torch.query import index as tindex
from repro_torch.query import scheduler as tsched

THREADS = 256                      # common.cuh's FW_THREADS
M32 = 0xFFFFFFFF


def _tkey(jkey):
    return convert.key_from_jax(jax.random.key_data(jkey), device="cpu")


def _draws(key, impl):
    """Every ``prng`` draw on ``key`` (one of each entry point)."""
    return [prng.random_bits(key, (5, 3), impl),
            prng.randint(key, (9,), -4, 70_000, impl),
            prng.uniform(key, (9,), impl),
            prng.bernoulli(key, 0.3, (9,), impl),
            prng.gumbel(key, (4,), impl),
            prng.categorical(key, torch.zeros(2, 6), impl),
            prng.split(key, 3, impl),
            prng.fold_in(key, 12, impl),
            prng.fold_in(key, torch.arange(-3, 4), impl)]


def test_cpu_key_never_builds_the_kernels(monkeypatch):
    """A CPU key runs the plain version under ``"auto"``, ``"torch"`` and
    ``draw_impl("torch")`` without touching the kernel library, and gives
    the same tensors each way."""
    def refuse():
        raise AssertionError("a CPU draw asked for the kernel library")

    monkeypatch.setattr(build, "library", refuse)
    key = prng.PRNGKey(7, "cpu")
    auto, plain = _draws(key, None), _draws(key, "torch")
    with prng.draw_impl("torch"):
        scoped = _draws(key, None)
    for a, b, c in zip(auto, plain, scoped):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.parametrize("scoped", [False, True])
def test_cuda_impl_on_a_cpu_key_raises(scoped):
    key = prng.PRNGKey(1, "cpu")
    calls = [lambda i: prng.random_bits(key, (3,), i),
             lambda i: prng.randint(key, (3,), 0, 9, i),
             lambda i: prng.uniform(key, (3,), i),
             lambda i: prng.bernoulli(key, 0.5, (3,), i),
             lambda i: prng.split(key, 2, i),
             lambda i: prng.fold_in(key, 3, i),
             lambda i: prng.categorical(key, torch.zeros(2, 3), i)]
    for call in calls:
        with pytest.raises(ValueError, match="impl='cuda' needs a CUDA key"):
            if scoped:
                with prng.draw_impl("cuda"):
                    call(None)
            else:
                call("cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        prng.split(key, 2, "pallas")
    with pytest.raises(ValueError, match="impl must be one of"):
        with prng.draw_impl("xla"):
            pass


# --- the draw kernels' C entry points, replayed in numpy uint32 ------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def np_threefry(k0, k1, x0, x1):
    """``threefry.cuh:fw_threefry2x32`` over broadcast uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def np_bits(k0, k1, ctr):
    return _np_bits(k0, k1, ctr)


def _np_bits(k0, k1, ctr):
    ctr = np.asarray(ctr, np.uint64)
    y0, y1 = np_threefry(k0, k1, (ctr >> np.uint64(32)).astype(np.uint32),
                         (ctr & np.uint64(M32)).astype(np.uint32))
    return y0 ^ y1


def np_uniform(b):
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def _view(ptr, dtype, count):
    """``count`` elements of ``dtype`` at host address ``ptr``, writable."""
    if count == 0:
        return np.zeros(0, dtype)
    buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(
        ptr)
    return np.frombuffer(buf, dtype)


def _cta_schedule(total, size):
    """Each element's ``(CTA's first key row, thread's key row relative to
    it, counter)``, as ``fw_at`` computes them from the CTA's first index
    and ``threadIdx.x``."""
    f = np.arange(total, dtype=np.uint64)
    f0 = f - f % np.uint64(THREADS)
    row0 = f0 // np.uint64(size)
    local = f0 - row0 * np.uint64(size) + f % np.uint64(THREADS)
    lrow = local // np.uint64(size)
    return f0, row0, lrow, local - lrow * np.uint64(size)


def _emulate(name, *args):
    """The C entry point ``fw_<name>`` on host memory, as the kernel
    computes it (the stream argument is absent: ``ops._launch`` adds it)."""
    if name == "threefry_fold_in":
        keys, key_step, data, data_step, data_bytes, scalar, out, total = args
        k = _view(keys, np.int64, 2 * (1 + (total - 1) * key_step))
        e = np.arange(total)
        if data is None:
            d = np.full(total, scalar, np.uint32)
        else:
            dt = np.int32 if data_bytes == 4 else np.int64
            d = _view(data, dt, 1 + (total - 1) * data_step)[
                e * data_step].astype(np.uint32)
        y0, y1 = np_threefry(k[2 * e * key_step], k[2 * e * key_step + 1], 0,
                             d)
        o = _view(out, np.int64, 2 * total).reshape(total, 2)
        o[:, 0], o[:, 1] = y0, y1
        return
    keys, out, nkeys, size, *rest = args
    k = _view(keys, np.int64, 2 * nkeys).reshape(nkeys, 2)
    total = nkeys * size
    if name == "threefry_split":
        i = np.arange(total)
        row = i // size
        y0, y1 = np_threefry(k[row, 0], k[row, 1], 0, i - row * size)
        o = _view(out, np.int64, 2 * total).reshape(total, 2)
        o[:, 0], o[:, 1] = y0, y1
        return
    f0, row0, lrow, ctr = _cta_schedule(total, size)
    row = (row0 + lrow).astype(np.int64)
    if name == "threefry_randint":
        lo, span, mult = rest
        # the CTA derives its rows' split keys, one row a thread
        cnt = np.minimum(np.uint64(total) - f0, np.uint64(THREADS))
        rows = (f0 - row0 * np.uint64(size) + cnt - np.uint64(1)) \
            // np.uint64(size) + np.uint64(1)
        assert (lrow < rows).all(), "an element reads a key row not derived"
        assert (row0 + rows <= np.uint64(nkeys)).all(), "a derivation reads " \
            "past the last key"
        lo_k = np_threefry(k[row, 0], k[row, 1], 0, 1)
        off = np_bits(*lo_k, ctr) % np.uint32(span)
        if mult:
            hi_k = np_threefry(k[row, 0], k[row, 1], 0, 0)
            with np.errstate(over="ignore"):
                off = (off + (np_bits(*hi_k, ctr) % np.uint32(span))
                       * np.uint32(mult)) % np.uint32(span)
        with np.errstate(over="ignore"):
            val = (np.uint32(lo & M32) + off).view(np.int32)
        _view(out, np.int32, total)[:] = val
        return
    b = np_bits(k[row, 0], k[row, 1], ctr)
    if name == "threefry_bits":
        _view(out, np.int64, total)[:] = b
    elif name == "threefry_uniform":
        _view(out, np.float32, total)[:] = np_uniform(b)
    else:
        _view(out, np.bool_, total)[:] = np_uniform(b) < np.float32(rest[0])


@pytest.fixture
def replayed(monkeypatch):
    """``prng`` routing every draw but ``impl="torch"`` to ``draw.py``, the
    CPU key notwithstanding, and ``ops._launch`` through :func:`_emulate`,
    counting as it does."""
    def launch(name, device, *args):
        _emulate(name, *args)
        ops.LAUNCHES[name] += 1
    monkeypatch.setattr(ops, "_launch", launch)
    monkeypatch.setattr(prng, "_on_card",
                        lambda name, key, impl: impl != "torch")


@pytest.mark.parametrize("batch,shape", [
    ((), (1,)), ((), (1023,)), ((), (1025,)), ((), (3, 7)), ((5,), (300,)),
    ((3, 4), (16,)), ((600,), (1,)), ((2, 3), (0,))])
def test_draw_launches_replayed_equal_plain(replayed, batch, shape):
    """Each draw through ``draw.py`` and the kernels' entry points, one
    launch each (none when empty), equal to ``prng``'s plain draw: spans
    that keep and drop the high stream, a negative ``minval``, the whole
    int32 range, ``maxval ≤ minval``, p at 0 and 1; batched keys."""
    keys = prng.split(prng.PRNGKey(len(batch) * 100 + sum(shape), "cpu"),
                      max(1, int(np.prod(batch))),
                      "torch").reshape(batch + (2,))
    empty = int(np.prod(batch + shape)) == 0
    cases = [("threefry_bits", lambda i: prng.random_bits(keys, shape, i)),
             ("threefry_uniform", lambda i: prng.uniform(keys, shape, i))]
    for lo, hi in [(0, 1 << 30), (0, 65_536), (0, 65_537), (-5, 100),
                   (0, 4_847_571), (-(1 << 31), (1 << 31) - 1), (9, 9)]:
        cases.append(("threefry_randint",
                      lambda i, lo=lo, hi=hi: prng.randint(keys, shape, lo,
                                                           hi, i)))
    for p in (0.0, 0.15, 1.0):
        cases.append(("threefry_bernoulli",
                      lambda i, p=p: prng.bernoulli(keys, p, shape, i)))
    for name, call in cases:
        want = call("torch")
        before = ops.launch_counts()[name]
        got = call(None)
        assert ops.launch_counts()[name] == before + (0 if empty else 1)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), name


@pytest.mark.parametrize("batch", [(), (5,), (3, 4)])
def test_split_and_fold_in_replayed_equal_plain(replayed, batch):
    """``split`` and ``fold_in`` through the kernels' entry points: a
    scalar datum, one datum a key, int32 and int64 data with negatives and
    values past 2**32, and data broadcast against the keys' batch."""
    keys = prng.split(prng.PRNGKey(3, "cpu"), max(1, int(np.prod(batch))),
                      "torch").reshape(batch + (2,))
    per_key = torch.arange(int(np.prod(batch)), dtype=torch.int32).reshape(
        batch) - 2
    wide = torch.tensor([0, -1, 2 ** 31, 2 ** 33 + 5, -(2 ** 40)],
                        dtype=torch.int64).reshape((5,) + (1,) * len(batch))
    calls = [("threefry_split", lambda i: prng.split(keys, 1, i)),
             ("threefry_split", lambda i: prng.split(keys, 32, i)),
             ("threefry_fold_in", lambda i: prng.fold_in(keys, -7, i)),
             ("threefry_fold_in", lambda i: prng.fold_in(keys, per_key, i)),
             ("threefry_fold_in", lambda i: prng.fold_in(keys, wide, i)),
             ("threefry_fold_in",
              lambda i: prng.fold_in(keys, wide.to(torch.int32), i))]
    for name, call in calls:
        want = call("torch")
        before = ops.launch_counts()[name]
        got = call(None)
        assert ops.launch_counts()[name] == before + 1
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), name


def test_replay_catches_a_wrong_stream(replayed, monkeypatch):
    """The replay's gate sees a wrong stream: randint with its two streams
    swapped, and bits at the counter off by one, differ from the plain
    draws."""
    key = prng.PRNGKey(11, "cpu")
    want_r = prng.randint(key, (999,), 0, 1000, "torch")
    want_b = prng.random_bits(key, (999,), "torch")
    real = np_threefry

    def swapped(k0, k1, x0, x1):
        x1 = np.asarray(x1, np.uint32)
        if np.ndim(x1) == 0 and int(x1) in (0, 1):    # split(key, 0 / 1)
            x1 = np.uint32(1 - int(x1))
        return real(k0, k1, x0, x1)

    monkeypatch.setattr(__import__(__name__), "np_threefry", swapped)
    assert not torch.equal(prng.randint(key, (999,), 0, 1000), want_r)
    monkeypatch.setattr(__import__(__name__), "np_threefry", real)
    monkeypatch.setattr(__import__(__name__), "np_bits",
                        lambda k0, k1, c: _np_bits(k0, k1, np.asarray(
                            c, np.uint64) + np.uint64(1)))
    assert not torch.equal(prng.random_bits(key, (999,)), want_b)


# --- the stitch kernels' rng="device" ----------------------------------------

def _stitch_inputs(W, n=97, R=5, S=4, seed=0):
    """Walk positions (some owned by no shard), round counts past the
    budget, stop flags, a stacked ``[S·sz, R]`` slab and its blocks."""
    rng = np.random.default_rng(seed)
    sz = -(-n // S)
    slab = rng.integers(0, n, (S * sz, R)).astype(np.int32)
    pos = rng.integers(0, n, W).astype(np.int32)
    q = rng.integers(0, 7, W).astype(np.int32)
    stop = rng.integers(0, 2, W).astype(np.int32)
    return pos, q, stop, slab, sz


Q_MAX = 5
WRAPPERS = {
    # name: the wrapper on (bits or key, rng, tensors)
    "stitch_gather": lambda b, m, t: ops.stitch_gather(
        t["pos"], b, t["slab"], rng=m),
    "stitch_step": lambda b, m, t: ops.stitch_step(
        t["pos"], t["stop"], b, t["ep"], t["n"], rng=m),
    "stitch_gather_local": lambda b, m, t: ops.stitch_gather_local(
        t["pos"], b, t["blocks"][1], t["sz"], rng=m),
    "stitch_step_local": lambda b, m, t: ops.stitch_step_local(
        t["pos"], t["stop"], b, t["blocks"][1], t["sz"], rng=m),
    "stitch_gather_rounds": lambda b, m, t: ops.stitch_gather_rounds(
        t["pos"], t["q"], b, t["slab"], Q_MAX, t["lost"], 4, t["sz"], rng=m),
    "stitch_step_rounds": lambda b, m, t: ops.stitch_step_rounds(
        t["pos"], t["q"], b, t["ep"], t["n"], Q_MAX, rng=m),
    "stitch_gather_local_rounds": lambda b, m, t:
        ops.stitch_gather_local_rounds(
            t["pos"], t["q"], b, ops.block_table(
                [None if s == 2 else blk
                 for s, blk in enumerate(t["blocks"])]),
            Q_MAX, t["lost"], rng=m),
}


def _operands(W, seed):
    pos, q, stop, slab, sz = _stitch_inputs(W, seed=seed)
    n = 97
    tslab = torch.from_numpy(slab)
    return dict(pos=torch.from_numpy(pos), q=torch.from_numpy(q),
                stop=torch.from_numpy(stop), slab=tslab, ep=tslab[:n], n=n,
                sz=sz, blocks=[tslab[s * sz:(s + 1) * sz] for s in range(4)],
                lost=torch.tensor([False, False, True, False]))


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_stitch_device_mode_equals_caller_mode(name):
    """Each stitch wrapper under ``rng="device"`` (the key in place of the
    bits) equals its caller mode fed ``prng.randint(key, (W,), 0,
    2**30)``, at W = 1 and 512, with a lost shard and a null table entry
    where the wrapper takes them; a device-mode key of the wrong form
    raises."""
    for W in (1, 512):
        t = _operands(W, W)
        key = prng.PRNGKey(W + 3, "cpu")
        s0 = prng.randint(key, (W,), 0, 1 << 30)
        got, want = (_outs(WRAPPERS[name](key, "device", t)),
                     _outs(WRAPPERS[name](s0, "caller", t)))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    with pytest.raises(ValueError, match="key must be a contiguous int64"):
        WRAPPERS[name](s0, "device", t)
    with pytest.raises(ValueError, match="rng must be one of"):
        WRAPPERS[name](key, "tpu", t)


def _reference(name, jbits, t):
    """The reference's caller-mode Pallas kernels (interpret mode) on the
    same operands, as its waves and ``walk_wave`` compose them."""
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()
         if isinstance(v, torch.Tensor)}
    n, sz = t["n"], t["sz"]
    zeros = jnp.zeros_like(j["pos"])
    blocks = [jnp.asarray(b.numpy()) for b in t["blocks"]]
    if name in ("stitch_gather", "stitch_step"):
        return jops.stitch_step(j["pos"], j["stop"], jbits,
                                j["slab"] if name == "stitch_gather"
                                else j["ep"], n, impl="pallas",
                                tally=name == "stitch_step")
    if name in ("stitch_gather_local", "stitch_step_local"):
        return jops.stitch_step_local(j["pos"], j["stop"], jbits, blocks[1],
                                      sz, impl="pallas",
                                      tally=name == "stitch_step_local")
    lost = np.asarray(t["lost"])
    pos, alive = j["pos"], jnp.ones_like(j["pos"], bool)
    counts = jnp.zeros(n, jnp.int32)
    for r in range(Q_MAX + (name == "stitch_step_rounds")):
        if name == "stitch_step_rounds":
            nxt, c = jops.stitch_step(pos, (j["q"] == r).astype(jnp.int32),
                                      jbits + r, j["ep"], n, impl="pallas")
            counts = counts + c
            pos = jnp.where(r < j["q"], nxt, pos)
            continue
        in_lost = jnp.asarray(lost)[jnp.clip(pos // sz, 0, 3)]
        alive = alive & ~(in_lost & (r < j["q"]))
        if name == "stitch_gather_rounds":
            nxt, _ = jops.stitch_step(pos, zeros, jbits + r, j["slab"], n,
                                      impl="pallas", tally=False)
        else:
            nxt = sum(jops.stitch_step_local(pos, zeros, jbits + r,
                                             blocks[s], s * sz,
                                             impl="pallas", tally=False)[0]
                      for s in range(4) if not lost[s])
        pos = jnp.where((r < j["q"]) & alive, nxt, pos)
    if name == "stitch_step_rounds":
        return pos, counts
    return pos, alive & ~jnp.asarray(lost)[jnp.clip(pos // sz, 0, 3)]


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_stitch_device_mode_equals_reference_kernels(name):
    """Each stitch wrapper's device mode against the reference's
    caller-mode Pallas kernels in interpret mode, their bits
    ``jax.random.randint(key, (W,), 0, 2**30)`` from the same key."""
    W = 300
    t = _operands(W, 7)
    jkey = jax.random.PRNGKey(41)
    jbits = jax.random.randint(jkey, (W,), 0, 1 << 30, jnp.int32)
    got = _outs(WRAPPERS[name](_tkey(jkey), "device", t))
    want = _outs(_reference(name, jbits, t))
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes(), name


# --- the waves and query_counts, through the device mode ---------------------

def _recording(monkeypatch, name):
    """Records the ``rng`` of each call of ``ops.<name>``."""
    seen = []
    real = getattr(ops, name)

    def wrapped(*a, **kw):
        seen.append(kw.get("rng", "caller"))
        return real(*a, **kw)
    monkeypatch.setattr(ops, name, wrapped)
    return seen


def _index_pair(n, R, L):
    gj = jgen.chung_lu_powerlaw(n, 5.0, seed=6)
    gt = tgen.chung_lu_powerlaw(n, 5.0, seed=6)
    ij = jindex._build_walk_index(gj, JWalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2))
    it = tindex._build_walk_index(gt, WalkIndexConfig(
        segments_per_vertex=R, segment_len=L, num_shards=2))
    return gj, gt, ij, it


@pytest.mark.parametrize("path", ["dense_wave", "loop_wave", "query_counts"])
def test_paths_equal_reference_through_device_mode(monkeypatch, path):
    """The dense wave, the loop wave (shard 1 of 3 lost) and
    ``query_counts`` (top-k and PPR) draw their slot offsets in the rounds
    kernel (``rng="device"``, one call) and give the reference's answers
    byte for byte."""
    n, R, L = 120, 5, 2
    gj, gt, ij, it = _index_pair(n, R, L)
    key = jax.random.PRNGKey(13)
    if path == "query_counts":
        seen = _recording(monkeypatch, "stitch_step_rounds")
        plan = jengine.plan_query(10, 0.5, 0.1, max_steps=10,
                                  segments_per_vertex=R, segment_len=L)
        for source in (None, 4):
            got = tengine.query_counts(gt, it, tengine.QueryPlan(
                **plan.__dict__), _tkey(key), source=source)
            want = jengine.query_counts(gj, ij, plan, key, source=source,
                                        impl="ref")
            assert got.numpy().tobytes() == np.asarray(want).tobytes()
        assert seen == ["device", "device"]
        return
    W, Q, S = 96, 3, 3
    rng = np.random.default_rng(2)
    qid = (np.arange(W) * Q // W).astype(np.int32)
    qid[-9:] = Q                                   # idle slots
    uniform = qid == 0
    start = np.where(uniform, 0, rng.integers(0, n, W)).astype(np.int32)
    t_cap = rng.integers(0, 12, W).astype(np.int32)
    operands = (start, uniform, qid, t_cap)
    kw = dict(max_walks=W, max_queries=Q, max_steps=10, seed=1)
    if path == "dense_wave":
        seen = _recording(monkeypatch, "stitch_gather_rounds")
        want = jsched.QueryScheduler(gj, ij, impl="ref", **kw)._wave_for(
            W, Q)(*map(jnp.asarray, operands), key, jnp.zeros(1, bool))
        got = tsched.QueryScheduler(gt, it, **kw)._wave_for(W, Q)(
            *map(torch.from_numpy, operands), _tkey(key), None)
    else:
        seen = _recording(monkeypatch, "stitch_gather_local_rounds")
        lost = np.array([False, True, False])
        sj, st = jindex.shard_walk_index(ij, S), tindex.shard_walk_index(it, S)
        want = jsched.QueryScheduler(gj, sj, impl="ref",
                                     sharded_dispatch="loop",
                                     **kw)._wave_for(W, Q)(
            *map(jnp.asarray, operands), key, jnp.asarray(lost))
        got = tsched.QueryScheduler(gt, st, sharded_dispatch="loop",
                                    **kw)._wave_for(W, Q)(
            *map(torch.from_numpy, operands), _tkey(key),
            torch.from_numpy(lost))
    assert seen == ["device"]
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
