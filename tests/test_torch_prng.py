"""The port's weather draws (``ops/prng.py``) and OU paths
(``ops/_year.py``) against JAX itself, on the CPU.

Bars:
- host keys, the threefry known-answer vector, the float32 ``log1p`` on the
  draw domain, ``normal_from_bits`` over every one of the 2^23 mantissas the
  pipeline can see, and the keyed ``(nt, K)`` tables: bitwise;
- the float64 table: bitwise JAX's on 10^6 draws. The 64-bit words, the
  uniforms, XLA's float64 erfinv polynomial, its rational ``log1p``, the
  square root and the C library's ``log`` that XLA:CPU calls
  (``prng.log_f64``, glibc's table path) are each JAX's bit for bit;
  ``log_f64`` is held to ``math.log`` bitwise on 10^6 inputs of its domain,
  the edges and every table interval's end points;
- the serial OU path: bitwise with JAX's ``lax.scan`` in float32 and
  float64; the associative path at engine parity (1e-5 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from energybalancemodel_jl_tpu.ops import prng as jprng
from energybalancemodel_jl_tpu_torch.ops import _year
from energybalancemodel_jl_tpu_torch.ops import prng

# the domain of prng.log_f64: 1 + x of the draw pipeline's log1p branch,
# x = -u^2 <= -(sqrt(2) - 1)
LOG_DOMAIN = (2.0 ** -52, 0.586)


def jax_keys(seed, members, year):
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(members, dtype=jnp.uint32))
    return np.asarray(jax.random.key_data(jax.vmap(lambda k: jax.random.fold_in(k, year))(keys)))


def bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("seed,year", [(0, 0), (7, 3), (123456789, 1999), (2 ** 31 - 1, 77)])
def test_host_keys_are_jax_key_data(seed, year):
    key = jax.random.key_data(jax.random.PRNGKey(seed))
    assert bits_equal(prng.prng_key(seed), np.asarray(key))
    assert bits_equal(prng.member_year_keys(seed, 9, year), jax_keys(seed, 9, year))


def test_threefry_known_answer_vector():
    z = np.zeros(1, np.uint32)
    o0, o1 = prng.threefry2x32(z, z, z, z)
    assert int(o0[0]) == 0x6B200159 and int(o1[0]) == 0x99BA4EFE
    t = torch.zeros(1, dtype=torch.int64)
    o0, o1 = prng.threefry2x32(t, t, t, t)
    assert int(o0) == 0x6B200159 and int(o1) == 0x99BA4EFE


@pytest.fixture(scope="module")
def mantissas():
    """Every 32-bit word the pipeline distinguishes: the 2^23 mantissas."""
    return np.arange(2 ** 23, dtype=np.uint32) << np.uint32(9)


def test_log1p_bitwise_on_the_draw_domain(mantissas):
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    f = ((mantissas >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    u = np.asarray(jax.jit(lambda f: jnp.maximum(lo, f * (np.float32(1) - lo) + lo))(f))
    x = -(u * u)
    assert bits_equal(prng.log1p_f32(torch.as_tensor(x)).numpy(), jax.jit(jnp.log1p)(x))


def test_normal_from_bits_bitwise_over_every_mantissa(mantissas):
    ref = jax.jit(jprng.normal_from_bits)(jnp.asarray(mantissas))
    mine = prng.normal_from_bits(torch.as_tensor(mantissas.astype(np.int64)))
    assert bits_equal(mine.numpy(), ref)
    assert np.isfinite(mine.numpy()).all() and float(mine.abs().max()) > 5.0


@pytest.mark.parametrize("nt", [1, 7, 200, 2000])
def test_normal_table_bitwise_vs_jax_random_normal(nt):
    keys = jax_keys(7, 5, 3)
    ref = jax.vmap(lambda k: jax.random.normal(k, (nt,), jnp.float32), out_axes=1)(keys)
    mine = prng.normal_table(keys, nt)
    assert mine.shape == (nt, 5) and mine.dtype == torch.float32
    assert bits_equal(mine.numpy(), ref)


def test_normal_table_f64_against_jax():
    keys = jax_keys(3, 500, 2)
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2000,), jnp.float64),
                              out_axes=1)(keys))
    mine = prng.normal_table_f64(keys, 2000).numpy()
    assert mine.dtype == np.float64 and mine.shape == ref.shape == (2000, 500)
    print(f"[f64 draws] {int((mine != ref).sum())} of 10^6 differ")
    assert bits_equal(mine, ref)


def test_normal_table_f64_bitwise_with_the_c_library_log(monkeypatch):
    """The C library's ``log`` is the target: with ``math.log`` itself in
    ``prng.log_f64``'s place, every draw is JAX's bit for bit too."""
    import math

    libm_log = lambda y: torch.as_tensor(np.vectorize(math.log, otypes=[np.float64])(y.numpy()))
    monkeypatch.setattr(prng, "log_f64", libm_log)
    keys = jax_keys(3, 500, 2)
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (400,), jnp.float64),
                              out_axes=1)(keys))
    assert bits_equal(prng.normal_table_f64(keys, 400).numpy(), ref)


def libm_log(y):
    import math

    return np.array([math.log(v) for v in y], np.float64)


def test_log_f64_is_the_c_library_log_bitwise():
    """10^6 seeded inputs over the domain, log-uniform and uniform."""
    rng = np.random.default_rng(5)
    lo, hi = LOG_DOMAIN
    y = np.concatenate([np.exp(rng.uniform(np.log(lo), np.log(hi), 500_000)),
                        rng.uniform(lo, hi, 500_000)])
    assert bits_equal(prng.log_f64(torch.as_tensor(y)).numpy(), libm_log(y))


def test_log_f64_at_the_edges_and_the_table_intervals():
    """The domain's ends, powers of two, and both sides of every boundary
    between glibc's 128 table intervals at every exponent of the domain."""
    lo, hi = LOG_DOMAIN
    k = np.arange(-53, 0, dtype=np.int64)[:, None]
    starts = ((k << 52) + prng.GLIBC_LOG_OFF + (np.arange(128, dtype=np.int64) << 45)[None, :])
    starts = starts.reshape(-1).view(np.float64)
    edges = np.array([lo, np.nextafter(lo, 1.0), hi, np.nextafter(hi, 0.0), 0.5, 0.25,
                      np.nextafter(0.5, 0.0), np.nextafter(0.5, 1.0), 0.5 ** 40])
    y = np.concatenate([starts, np.nextafter(starts, 0.0), np.nextafter(starts, 1.0), edges])
    y = y[(y >= lo) & (y <= hi)]
    assert y.size > 3 * 128 * 50
    assert bits_equal(prng.log_f64(torch.as_tensor(y)).numpy(), libm_log(y))


def test_sqrt_f64_is_correctly_rounded():
    """``prng.sqrt_f64`` against numpy's hardware square root, where
    ``torch.sqrt`` on the CPU is off in the last bit of some inputs."""
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.uniform(0, 40, 500_000), rng.exponential(1.0, 500_000),
                        [0.0, 1e-300, 4.0]])
    assert bits_equal(prng.sqrt_f64(torch.as_tensor(w)).numpy(), np.sqrt(w))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ou_path_bitwise_with_lax_scan(dtype):
    rng = np.random.default_rng(4)
    nt, K = 500, 16
    xi = rng.normal(size=(nt, K)).astype(dtype)
    eta0 = (rng.normal(size=K) * 3).astype(dtype)
    rho, scale = np.asarray(np.exp(-1 / 500 / 0.05), dtype), np.asarray(2.0, dtype)

    def ou(e, z):
        e = rho * e + scale * z
        return e, e

    ref = np.asarray(jax.jit(lambda x, e: lax.scan(ou, e, x)[1])(xi, eta0))
    t = lambda v: torch.as_tensor(v)
    mine = _year.ou_path(t(xi), t(rho), t(scale), t(eta0)).numpy()
    assert bits_equal(mine, ref)
    assoc = _year.assoc_ou_path(t(xi), t(rho), t(scale), t(eta0)).numpy()
    np.testing.assert_allclose(assoc, ref, rtol=1e-5, atol=1e-5)
    # scale 0 and eta0 0: exactly zero on both paths
    zero = t(np.zeros(K, dtype))
    assert not _year.assoc_ou_path(t(xi), t(rho), t(np.asarray(0.0, dtype)), zero).any()
    assert not _year.ou_path(t(xi), t(rho), t(np.asarray(0.0, dtype)), zero).any()


def test_fma_f32_is_one_rounding():
    """The float32 fused multiply-add emulation against exact rational
    arithmetic, on triples chosen so that a double rounding would differ."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.normal(size=4000).astype(np.float32)
    b = rng.normal(size=4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) + rng.normal(size=4000) * 1e-7).astype(np.float32)
    got = prng.fma_f32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    for i in range(0, 4000, 7):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.int32)) & 1))
        assert got[i] == best, i
