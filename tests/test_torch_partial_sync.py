"""The port's partial synchronization over a mesh against the reference's,
on the CPU.

The reference's ``core/partial_sync.py`` runs under ``jax.shard_map`` on 8
forced host devices, in one subprocess for the module: one compiled
program takes 32 keys as an argument and writes the coins, the channel
masks (with and without the Example-10 forcing, p_s from 0.01 to 1), the
forced channel, ``partial_all_to_all``'s output and mask, and
``partial_psum``'s outputs and residuals (both modes, three
error-feedback rounds) to an ``.npz``. The port's functions run on a
``ShardMesh(8, "cpu")`` in this process: masks, coins and the forced
channel byte-equal, the sums and residuals within 1e-6 relative. The
reference's statistical claims (``tests/test_multidevice.py:54-103``) are
then held on the port alone: 300 keys for the unbiased mean, 30
error-feedback rounds, a channel open at p_s = 0.01.
"""

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch import prng
from repro_torch.core import (partial_all_to_all, partial_channel_mask,
                              partial_psum)
from repro_torch.core.partial_sync import _shard_coin
from repro_torch.distributed.runtime import ShardMesh

S = 8
NUM_KEYS = 32
COIN_PS = (0.3, 0.5, 0.9)
MASK_PS = (0.01, 0.3, 0.5, 1.0)
A2A = ((0.3, True), (0.3, False), (1.0, True))
PSUM_PS = (0.5, 1.0)
EF_ROUNDS = 3


def _x():
    """float32[S, 3]: shard s contributes row s."""
    return np.random.default_rng(0).standard_normal((S, 3)).astype(
        np.float32)


def _xa():
    """float32[S, S, 2]: shard s sends row d to shard d."""
    return np.random.default_rng(1).standard_normal((S, S, 2)).astype(
        np.float32)


REFERENCE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.partial_sync import (_shard_coin, partial_all_to_all,
                                     partial_channel_mask, partial_psum)
S, COIN_PS, MASK_PS, A2A, PSUM_PS, EF = {S}, {COIN_PS}, {MASK_PS}, {A2A}, \\
    {PSUM_PS}, {EF_ROUNDS}
mesh = jax.make_mesh((S,), ("d",), axis_types=(jax.sharding.AxisType.Auto,))
keys = jnp.stack([jax.random.PRNGKey(i) for i in range({NUM_KEYS})])
x = jnp.asarray(np.random.default_rng(0).standard_normal((S, 3)).astype(
    np.float32))
xa = jnp.asarray(np.random.default_rng(1).standard_normal((S, S, 2)).astype(
    np.float32))

def one_key(a, b, key):
    out = {{}}
    for p in COIN_PS:
        out[f"coin_{{p}}"] = _shard_coin(key, p, "d")
    for p in MASK_PS:
        for f in (True, False):
            out[f"mask_{{p}}_{{f}}"] = partial_channel_mask(key, p, "d", S, f)
    k = jax.random.fold_in(key, jax.lax.axis_index("d"))
    out["forced"] = jax.random.randint(jax.random.split(k)[1], (), 0, S)
    for p, c in A2A:
        o, m = partial_all_to_all(b, "d", p, key, S, compensate=c)
        out[f"a2a_{{p}}_{{c}}"], out[f"a2a_mask_{{p}}_{{c}}"] = o, m
    for p in PSUM_PS:
        out[f"psum_{{p}}"] = partial_psum(a, "d", p, key)
    res = None
    for t in range(EF):
        o, res = partial_psum(a, "d", 0.5, jax.random.fold_in(key, t),
                              mode="error_feedback", residual=res)
        out[f"ef_out_{{t}}"], out[f"ef_res_{{t}}"] = o, res
    return out

def body(a, b, keys):
    out = jax.lax.map(lambda k: one_key(a[0], b[0], k), keys)
    return {{name: v[None] for name, v in out.items()}}

fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("d"), P("d"), P()),
                           out_specs=P("d"), check_vma=False))
out = fn(x, xa, keys)
np.savez({path!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("REF-OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs: ``name → [S, NUM_KEYS, ...]``."""
    path = tmp_path_factory.mktemp("partial_sync") / "ref.npz"
    script = REFERENCE.format(S=S, COIN_PS=COIN_PS, MASK_PS=MASK_PS, A2A=A2A,
                              PSUM_PS=PSUM_PS, EF_ROUNDS=EF_ROUNDS,
                              NUM_KEYS=NUM_KEYS, path=str(path))
    assert "REF-OK" in run_with_devices(script, n_devices=S)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def mesh():
    return ShardMesh(S, "cpu")


def _key(i):
    return prng.PRNGKey(i, "cpu")


def _ref_at(reference, name, i):
    """The reference's output ``name`` for key ``i``, a shard a row."""
    return reference[name][:, i]


@pytest.mark.parametrize("p", COIN_PS)
def test_shard_coins_equal_the_reference(reference, mesh, p):
    for i in range(NUM_KEYS):
        got = _shard_coin(_key(i), p, mesh).numpy()
        np.testing.assert_array_equal(got, _ref_at(reference,
                                                   f"coin_{p}", i))


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("p", MASK_PS)
def test_channel_masks_equal_the_reference(reference, mesh, p, force):
    for i in range(NUM_KEYS):
        got = partial_channel_mask(_key(i), p, mesh, S, force).numpy()
        assert got.dtype == np.bool_ and got.shape == (S, S)
        np.testing.assert_array_equal(
            got, _ref_at(reference, f"mask_{p}_{force}", i))


def test_forced_channel_equals_the_reference(reference, mesh):
    """The channel a fully closed shard opens: ``randint(split(fold_in(key,
    s))[1], (), 0, S)``, byte-equal; and at p_s = 0.01 the forced masks
    differ from the unforced ones exactly there."""
    forced_seen = 0
    for i in range(NUM_KEYS):
        ks = prng.split(mesh.shard_key(_key(i)))
        forced = prng.randint(ks[:, 1], (), 0, S).numpy()
        np.testing.assert_array_equal(forced, _ref_at(reference, "forced",
                                                      i))
        on = partial_channel_mask(_key(i), 0.01, mesh, S, True)
        off = partial_channel_mask(_key(i), 0.01, mesh, S, False)
        closed = ~off.any(1)
        want = off.clone()
        want[closed, torch.as_tensor(forced)[closed].long()] = True
        assert torch.equal(on, want)
        forced_seen += int(closed.sum())
    assert forced_seen > 0


@pytest.mark.parametrize("p,compensate", A2A)
def test_partial_all_to_all_equals_the_reference(reference, mesh, p,
                                                 compensate):
    xa = torch.from_numpy(_xa())
    for i in range(NUM_KEYS):
        out, coins = partial_all_to_all(xa, mesh, p, _key(i), S,
                                        compensate=compensate)
        np.testing.assert_array_equal(
            coins.numpy(), _ref_at(reference, f"a2a_mask_{p}_{compensate}",
                                   i))
        # a pure permutation and scaling: the same float32 bytes
        np.testing.assert_array_equal(
            out.numpy(), _ref_at(reference, f"a2a_{p}_{compensate}", i))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("p", PSUM_PS)
def test_partial_psum_unbiased_equals_the_reference(reference, mesh, p):
    x = torch.from_numpy(_x())
    for i in range(NUM_KEYS):
        got = partial_psum(x, mesh, p, _key(i)).numpy()
        want = _ref_at(reference, f"psum_{p}", i)
        assert got.shape == want.shape == (S, 3)
        assert _rel(got, want) <= 1e-6, i


def test_partial_psum_error_feedback_equals_the_reference(reference, mesh):
    x = torch.from_numpy(_x())
    for i in range(NUM_KEYS):
        res = None
        for t in range(EF_ROUNDS):
            out, res = partial_psum(x, mesh, 0.5,
                                    prng.fold_in(_key(i), t),
                                    mode="error_feedback", residual=res)
            assert _rel(out.numpy(),
                        _ref_at(reference, f"ef_out_{t}", i)) <= 1e-6
            assert _rel(res.numpy(),
                        _ref_at(reference, f"ef_res_{t}", i)) <= 1e-6


def test_partial_psum_takes_trees(mesh):
    """A dict / tuple tree sums leaf by leaf, as the reference's pytrees."""
    x = torch.from_numpy(_x())
    tree = {"a": x, "b": (2 * x, x[:, :1])}
    got = partial_psum(tree, mesh, 0.5, _key(3))
    assert torch.equal(got["a"], partial_psum(x, mesh, 0.5, _key(3)))
    assert torch.equal(got["b"][1], partial_psum(x[:, :1], mesh, 0.5,
                                                 _key(3)))
    out, res = partial_psum(tree, mesh, 1.0, _key(3), mode="error_feedback")
    assert res is None and torch.equal(out["a"], mesh.psum(x))
    with pytest.raises(ValueError, match="unknown mode"):
        partial_psum(x, mesh, 0.5, _key(3), mode="sometimes")


# --- the reference's statistical claims, on the port alone ------------------


def _ranks():
    """shard s holds s + 1 (``test_multidevice.py``'s input)."""
    return torch.arange(S, dtype=torch.float32).reshape(S, 1) + 1.0


def test_unbiased_mean_over_300_keys(mesh):
    x = _ranks()
    true_sum = float(x.sum())
    vals = [float(partial_psum(x, mesh, 0.5, _key(i))[0, 0])
            for i in range(300)]
    assert abs(np.mean(vals) - true_sum) / true_sum < 0.1


def test_error_feedback_conserves_mass_over_30_rounds(mesh):
    x = _ranks()
    true_sum = float(x.sum())
    key = _key(42)
    res, tot = None, torch.zeros_like(x)
    for t in range(30):
        out, res = partial_psum(x, mesh, 0.5, prng.fold_in(key, t),
                                mode="error_feedback", residual=res)
        tot = tot + out
    assert abs(float(tot[0, 0]) / 30 - true_sum) / true_sum < 0.25


def test_some_channel_open_at_tiny_p_s(mesh):
    for i in range(20):
        m = partial_channel_mask(_key(i), 0.01, mesh, S)
        assert int(m.sum(1).min()) >= 1
