"""The noisy whole-year kernels and the draw kernel on the card, against their
plain PyTorch versions on the same inputs: the noise modes of
``csrc/miz_year.cu`` and ``csrc/classic_year.cu`` (``noise=``,
``noise_ou=``, ``noise_keys=``, ``ou_assoc=True``, ``crossing=``) and
``csrc/normal_table.cu`` (``ops/prng.py``).

Every test needs a CUDA device and nvcc; without them each skips (decided in
the ``cuda`` fixture, never at import). Run on a GPU with::

    python -m pytest --noconftest tests/test_torch_cuda_noise.py -q

Bars:
- the draws: bitwise, over all 2^23 mantissas the pipeline can see and on
  keyed tables;
- MIZ, float32 with a fixed Newton iteration count, every mode: bitwise
  (the kernel rounds where the plain version does; the scan and the
  crossing sum run in the plain version's order); float64 table/OU with the
  adaptive Newton: 1e-8 (rtol and atol), eta bitwise;
- Classic (no Newton loop), every mode, float32 and float64: bitwise, on
  the warp builds (nx <= 256) and the block build at every slot class;
- sigma = 0 (scale 0, eta0 0): bitwise the deterministic kernel's year;
- the kernel's per-member Newton update counts: the year unchanged by
  counting, each member's count its solo run's, and within max_iter * nt.
"""
import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.models.base import StepConfig, default_step_config
from energybalancemodel_jl_tpu_torch.ops import miz_year as my, classic_year as cy, prng
from energybalancemodel_jl_tpu_torch.ops.normal_table import normal_from_bits, normal_table

pytestmark = pytest.mark.gpu

FIXED32 = StepConfig(solver="pcr", newton_abstol=0.0, newton_reltol=0.0,
                     newton_max_step=50.0, newton_max_iter=8)
OU = (0.95, 3.0, 0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def bitwise(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def assert_same(out_k, out_p, rtol=0.0):
    """Carry, seasonal stores, and the eta / crossing results."""
    torch.cuda.synchronize()
    pairs = [(out_k[0][k], out_p[0][k]) for k in out_k[0]]
    pairs += [(a[k], b[k]) for a, b in zip(out_k[1], out_p[1]) for k in a]
    for a, b in pairs:
        if rtol == 0.0:
            assert bitwise(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=rtol, atol=rtol, equal_nan=True)
    for a, b in zip(out_k[3:], out_p[3:]):
        assert (a is None) == (b is None)
        if a is not None:
            assert bitwise(a, b)


def miz_setup(dev, dtype, K=8, nx=40, nt=200):
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = ebt.default_parameters("MIZ")
    par["D"] = np.linspace(0.55, 0.65, K)
    carry = ebt.Collection({k: torch.zeros((K, nx), dtype=dtype, device=dev)
                            for k in my.CARRY_KEYS})
    return st, par, carry, torch.zeros(nt, dtype=dtype, device=dev)


def classic_setup(dev, dtype, K=8, nx=40, nt=1000):
    st = ebt.SpaceTime.sin(nx, nt, 1)
    par = ebt.default_parameters("Classic")
    par["D"] = np.linspace(0.55, 0.65, K)
    E = torch.full((K, nx), 30.0, dtype=dtype, device=dev)
    return st, par, ebt.Collection(E=E, Tg=E / par["cw"]), torch.zeros(nt, dtype=dtype,
                                                                      device=dev)


def modes(K, nt, dtype, dev, st):
    """Every keyword mode, with seeded inputs; crossing thresholds from the
    middle of the area range so that members cross (none at nx = 1)."""
    keys = prng.member_year_keys(5, K, 2)
    table = torch.as_tensor(np.random.default_rng(3).normal(size=(nt, K)), dtype=dtype,
                            device=dev)
    out = {"table": dict(noise=table), "table_ou": dict(noise=table, noise_ou=OU)}
    if dtype == torch.float32 and st.nx > 1:
        thr = float(np.sum(np.diff(st.x))) * 0.3
        out.update({
            "keys_serial": dict(noise_keys=keys, noise_ou=OU),
            "keys_assoc": dict(noise_keys=keys, noise_ou=OU, ou_assoc=True),
            "keys_crossing": dict(noise_keys=keys, noise_ou=OU, crossing=(thr, 1.0)),
            "keys_assoc_crossing": dict(noise_keys=keys, noise_ou=OU, ou_assoc=True,
                                        crossing=(thr, -1.0)),
        })
    return out


def test_draw_kernel_bitwise_over_every_mantissa(cuda):
    bits = torch.arange(2 ** 23, dtype=torch.int64, device=cuda) << 9
    assert bitwise(normal_from_bits(bits), prng.normal_from_bits(bits))


@pytest.mark.parametrize("nt,K", [(1, 3), (200, 64), (2000, 512)])
def test_draw_kernel_bitwise_on_keyed_tables(cuda, nt, K):
    keys = prng.member_year_keys(7, K, 3)
    assert bitwise(normal_table(keys, nt, cuda), prng.normal_table(keys, nt, cuda))


@pytest.mark.parametrize("mode", ["table", "table_ou", "keys_serial", "keys_assoc",
                                  "keys_crossing", "keys_assoc_crossing"])
def test_miz_noise_modes_f32_fixed_newton_bitwise(cuda, mode):
    st, par, carry, f = miz_setup(cuda, torch.float32)
    kw = modes(8, st.nt, torch.float32, cuda, st)[mode]
    assert_same(my.miz_year(carry, par, f, st, FIXED32, **kw),
                my.miz_year_reference(carry, par, f, st, FIXED32, **kw))


def test_miz_table_ou_f64(cuda):
    st, par, carry, f = miz_setup(cuda, torch.float64)
    kw = modes(8, st.nt, torch.float64, cuda, st)["table_ou"]
    cfg = default_step_config("float64")
    assert_same(my.miz_year(carry, par, f, st, cfg, **kw),
                my.miz_year_reference(carry, par, f, st, cfg, **kw), rtol=1e-8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["table", "table_ou", "keys_serial", "keys_assoc",
                                  "keys_crossing", "keys_assoc_crossing"])
def test_classic_noise_modes_bitwise(cuda, dtype, mode):
    st, par, carry, f = classic_setup(cuda, dtype)
    kw = modes(8, st.nt, dtype, cuda, st).get(mode)
    if kw is None:
        pytest.skip("keys modes draw float32 only")
    cfg = default_step_config(str(dtype).rsplit(".", 1)[-1])
    assert_same(cy.classic_year(carry, par, f, st, cfg, **kw),
                cy.classic_year_reference(carry, par, f, st, cfg, **kw))


@pytest.mark.parametrize("build", ["warp", "block"])
@pytest.mark.parametrize("nx", [1, 31, 32, 33, 180, 255, 256, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_classic_warp_builds_noise_modes_bitwise(cuda, dtype, nx, build):
    """Every mode the dtype takes, on the warp builds and on the block build
    (nx = 257: the block build both times); nx = 1 has no crossing area."""
    st, par, carry, f = classic_setup(cuda, dtype, K=6, nx=nx, nt=300)
    cfg = default_step_config(str(dtype).rsplit(".", 1)[-1])
    saved = cy.WARP_MIN_K
    cy.WARP_MIN_K = 1 if build == "warp" else 2 ** 30
    try:
        for mode, kw in modes(6, st.nt, dtype, cuda, st).items():
            if nx == 1 and "crossing" in mode:
                continue
            assert_same(cy.classic_year(carry, par, f, st, cfg, **kw),
                        cy.classic_year_reference(carry, par, f, st, cfg, **kw))
    finally:
        cy.WARP_MIN_K = saved


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_sigma_zero_is_the_deterministic_kernel(cuda, model):
    setup, year = (miz_setup, my.miz_year) if model == "MIZ" else (classic_setup, cy.classic_year)
    st, par, carry, f = setup(cuda, torch.float32)
    cfg = default_step_config("float32")
    keys = prng.member_year_keys(1, 8, 0)
    for kw in (dict(noise_keys=keys, noise_ou=(0.9, 0.0, 0.0)),
               dict(noise_keys=keys, noise_ou=(0.9, 0.0, 0.0), ou_assoc=True)):
        noisy = year(carry, par, f, st, cfg, **kw)
        det = year(carry, par, f, st, cfg)
        torch.cuda.synchronize()
        assert all(bitwise(noisy[0][k], det[0][k]) for k in det[0])
        assert all(bitwise(a[k], b[k]) for a, b in zip(noisy[1], det[1]) for k in a)
        assert torch.equal(noisy[3], torch.zeros_like(noisy[3]))


def test_noisy_launch_counts_and_refusals(cuda):
    st, par, carry, f = miz_setup(cuda, torch.float32)
    keys = prng.member_year_keys(1, 8, 0)
    before = my.miz_year.launches
    my.miz_year(carry, par, f, st, FIXED32, noise_keys=keys, noise_ou=OU)
    assert my.miz_year.launches == before + 1
    with pytest.raises(ValueError, match="requires noise_ou"):
        my.miz_year(carry, par, f, st, FIXED32, noise_keys=keys)
    big = ebt.SpaceTime.sin(40, 20000, 1)
    with pytest.raises(ValueError, match="shared memory"):
        my.miz_year(carry, par, torch.zeros(20000, device=cuda), big, FIXED32,
                    noise_keys=keys, noise_ou=OU, ou_assoc=True)


def test_newton_update_counts(cuda):
    st, par, carry, f = miz_setup(cuda, torch.float32)
    cfg = default_step_config("float32")
    keys = prng.member_year_keys(1, 8, 0)
    counts = {}
    for label, cfg_, kw in (("det", cfg, {}), ("fixed", FIXED32, {}),
                            ("sigma0", cfg, dict(noise_keys=keys, noise_ou=(0.9, 0.0, 0.0)))):
        n = torch.full((8,), -1, dtype=torch.int32, device=cuda)
        counted = my.miz_year(carry, par, f, st, cfg_, newton_iters=n, **kw)
        assert_same(counted, my.miz_year(carry, par, f, st, cfg_, **kw))
        assert bool(((n > 0) & (n <= cfg_.newton_max_iter * st.nt)).all()), label
        counts[label] = n
    # the noisy build at sigma = 0 runs the deterministic trajectory
    assert torch.equal(counts["sigma0"], counts["det"])
    # per-member Newton: a member counts what it counts alone
    solo = torch.zeros(1, dtype=torch.int32, device=cuda)
    my.miz_year(ebt.Collection({k: v[5:6] for k, v in carry.items()}),
                dict(par, D=par["D"][5]), f, st, cfg, newton_iters=solo)
    assert int(solo[0]) == int(counts["det"][5])
    with pytest.raises(ValueError, match="int32"):
        my.miz_year(carry, par, f, st, cfg, newton_iters=torch.zeros(8, device=cuda))
