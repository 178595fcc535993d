"""The port's Threefry core and per-world RNG (madsim_tpu_torch.ops.threefry,
madsim_tpu_torch.engine.rng) against the JAX package, bitwise.

Tolerance: none. Every operation is integer arithmetic, or a float32
product that is exact (a 24-bit integer times 2^-24).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.engine import rng as jrng
from madsim_tpu.ops import threefry as jtf
from madsim_tpu_torch.engine import rng as trng
from madsim_tpu_torch.engine import step_kernel
from madsim_tpu_torch.ops import threefry as ttf

# Random123 known-answer vectors for threefry2x32, 20 rounds (the constants
# of tests/test_threefry.py): (counter, key) -> expected output.
KAT = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3), (0x13198A2E, 0x03707344), (0xC4923A9C, 0x483DF7A0)),
]


def u32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)) \
        .to(torch.uint32)


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int64).numpy().astype(np.uint32) \
        if t.dtype == torch.uint32 else t.numpy()


@pytest.mark.parametrize("impl", ["torch", "numpy", "scalar", "wrapper"])
def test_known_answer_vectors(impl):
    for (c0, c1), (k0, k1), (e0, e1) in KAT:
        if impl == "torch":
            x0, x1 = ttf.threefry2x32_torch(u32([k0]), u32([k1]), u32([c0]),
                                            u32([c1]))
            got = (int(as_np(x0)[0]), int(as_np(x1)[0]))
        elif impl == "numpy":
            x0, x1 = ttf.threefry2x32_np(k0, k1, c0, c1)
            got = (int(x0), int(x1))
        elif impl == "scalar":
            got = ttf.threefry2x32_scalar(k0, k1, c0, c1)
        else:  # the kernel wrapper takes its plain version on the CPU
            x0, x1 = step_kernel.threefry2x32(u32([k0]), u32([k1]),
                                              u32([c0]), u32([c1]))
            got = (int(as_np(x0)[0]), int(as_np(x1)[0]))
        assert got == (e0, e1), f"{impl}: ctr={c0:#x},{c1:#x} key={k0:#x},{k1:#x}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_matches_jax_and_numpy_on_random_keys(seed):
    rng = np.random.default_rng(seed)
    k0, k1, c0, c1 = (rng.integers(0, 2**32, size=512, dtype=np.uint32)
                      for _ in range(4))
    # Counters crossing 2^32 - 1, where a u32 add wraps.
    c0[:6] = [2**32 - 3, 2**32 - 2, 2**32 - 1, 0, 1, 2]
    c1[:6] = 2**32 - 1
    t0, t1 = ttf.threefry2x32_torch(u32(k0), u32(k1), u32(c0), u32(c1))
    j0, j1 = jtf.threefry2x32_jax(k0, k1, c0, c1)
    n0, n1 = jtf.threefry2x32_np(k0, k1, c0, c1)
    np.testing.assert_array_equal(as_np(t0), np.asarray(j0))
    np.testing.assert_array_equal(as_np(t1), np.asarray(j1))
    np.testing.assert_array_equal(as_np(t0), n0)
    np.testing.assert_array_equal(as_np(t1), n1)
    p0, p1 = ttf.threefry2x32_np(k0, k1, c0, c1)
    np.testing.assert_array_equal(p0, n0)
    np.testing.assert_array_equal(p1, n1)


def test_stream_derivation_matches():
    for seed in (0, 7, 2**40 + 3, 2**64 - 1):
        k0, k1 = ttf.seed_to_key(seed)
        assert (k0, k1) == jtf.seed_to_key(seed)
        for stream in (0, 16, 2**33 + 5):
            want = jtf.derive_stream_np(k0, k1, stream)
            got = ttf.derive_stream_torch(u32([k0]), u32([k1]), stream)
            assert (int(as_np(got[0])[0]), int(as_np(got[1])[0])) == \
                (int(want[0]), int(want[1]))
            assert ttf.derive_stream_np(k0, k1, stream) == want


def _rand_cursor(rng, w):
    k0, k1 = (rng.integers(0, 2**32, size=w, dtype=np.uint32) for _ in range(2))
    ctr = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    ctr[:4] = [2**32 - 3, 2**32 - 2, 2**32 - 1, 0]  # wrapping cursors
    return k0, k1, ctr


def test_make_rng_matches_jax():
    rng = np.random.default_rng(3)
    lo, hi = (rng.integers(0, 2**32, size=64, dtype=np.uint32) for _ in range(2))
    want = jax.vmap(lambda a, b: jrng.make_rng(a, b, 16))(lo, hi)
    got = trng.make_rng(u32(lo), u32(hi), 16)
    for name in ("k0", "k1", "counter"):
        np.testing.assert_array_equal(as_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
        assert getattr(got, name).dtype == torch.uint32


@pytest.mark.parametrize("k", [1, 8])
def test_next_u32_vec_matches_jax(k):
    rng = np.random.default_rng(4)
    k0, k1, ctr = _rand_cursor(rng, 64)
    jr = jrng.DevRng(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(ctr))
    jx, jr2 = jax.vmap(lambda r: jrng.next_u32_vec(r, k))(jr)
    tx, tr2 = trng.next_u32_vec(trng.DevRng(u32(k0), u32(k1), u32(ctr)), k)
    np.testing.assert_array_equal(tx.numpy().astype(np.uint32),
                                  np.asarray(jx))
    np.testing.assert_array_equal(as_np(tr2.counter), np.asarray(jr2.counter))


def test_draw_mappings_match_jax():
    """_u32_to_range (unsigned modulo of uint32(high-low)),
    _u32_to_unit_f32 (top 24 bits x 2^-24) and uniform_u32."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    low = rng.integers(0, 2**20, size=4096).astype(np.int32)
    high = (low + rng.integers(1, 2**31 - 2**20, size=4096)).astype(np.int32)
    want = np.asarray(jrng._u32_to_range(jnp.asarray(x), low, high))
    got = trng._u32_to_range(torch.from_numpy(x.astype(np.int64)),
                             torch.from_numpy(low), torch.from_numpy(high))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_u = np.asarray(jrng._u32_to_unit_f32(jnp.asarray(x)))
    got_u = trng._u32_to_unit_f32(torch.from_numpy(x.astype(np.int64)))
    assert got_u.dtype == torch.float32
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    k0, k1, ctr = _rand_cursor(rng, 64)
    jr = jrng.DevRng(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(ctr))
    jv, jr2 = jax.vmap(lambda r: jrng.uniform_u32(r, 150_000, 300_000))(jr)
    tv, tr2 = trng.uniform_u32(trng.DevRng(u32(k0), u32(k1), u32(ctr)),
                               150_000, 300_000)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(as_np(tr2.counter), np.asarray(jr2.counter))
