"""The multi-device layer of the PyTorch port on the CPU: the mesh and its
collectives, the halo exchange, the SPIKE solve, and the member-sharded
drivers (``parallel/mesh.py``, ``halo.py``, ``sharding.py``, ``ops/spike.py``
and the ``mesh=`` of ``ensemble_integrate``, ``transitions``,
``equilibrate``, ``stability`` and ``lyapunov``).

The port's meshes are ``Mesh([cpu] * 8)`` (one device repeated: each entry a
shard in a thread of its own); the JAX side runs on conftest's 8 virtual CPU
devices, float64. Bars:
- against JAX on the same 8-shard mesh: ``neighbor_cells`` under
  ``shard_map`` and ``sharded_diffusion`` bitwise; ``spike_tridiag_solve``
  within 1e-12 relative of JAX's (n=64, and a (4, 32) batch) and of dense
  numpy within rtol 1e-10 / atol 1e-12; ``shard_map_year_fn``'s global mean
  within rtol 1e-10 (the port's batch iterates Newton in lockstep, JAX's
  vmap per member: they part below the f64 Newton tolerance);
- sharded against unsharded in the port, on the plain versions: bitwise for
  ``ensemble_integrate(mesh=)``, ``sharded_ensemble_integrate`` (and its
  replicated fallback when K does not divide), ``transitions(mesh=)`` on
  both engines, ``equilibrate(mesh=)`` with its checkpoint, ``stability`` and
  ``lyapunov(mesh=)``;
- the collectives reduce in shard order (bitwise repeatable), a shard's
  exception reaches the caller within a second, and the launch counts stay
  exact under many concurrent shards.
The JAX ``shard_map`` graphs are few and tiny (XLA:CPU compile state,
tests/conftest.py). ~40 s on one worker here. The ``gpu``-marked tests hold
the per-shard kernel launches on the card and skip here; JAX is imported
inside the tests that use it, so ``python -m pytest --noconftest
tests/test_torch_parallel.py -m gpu`` runs them where jax is missing.
"""
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import energybalancemodel_jl_tpu_torch as ebt
from energybalancemodel_jl_tpu_torch.ops import _build
from energybalancemodel_jl_tpu_torch.ops.diffusion import neighbor_cells
from energybalancemodel_jl_tpu_torch.ops.spike import spike_tridiag_solve
from energybalancemodel_jl_tpu_torch.ops.tridiag import tridiag_solve
from energybalancemodel_jl_tpu_torch.parallel import mesh as M
from energybalancemodel_jl_tpu_torch.parallel.halo import grid_mesh, sharded_diffusion
from energybalancemodel_jl_tpu_torch.parallel.sharding import (
    ensemble_mesh, shard_map_fused_year_fn, shard_map_year_fn, sharded_ensemble_integrate)

CPU = torch.device("cpu")
T64 = torch.float64
ST = ebt.SpaceTime.sin(16, 50, 1)


def cpu_mesh(n=8, axis="x"):
    return M.Mesh([CPU] * n, (axis,))


def jax_mesh(axis="x"):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def swept(K=8, model="MIZ"):
    par = ebt.Collection(ebt.default_parameters(model))
    par["D"] = np.linspace(0.55, 0.65, K) if model == "MIZ" else np.linspace(0.5, 0.7, K)
    return par


def same(a, b):
    """Bitwise equality of two Collections of arrays (NaN where NaN)."""
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True) for k in a)


# -- the mesh and its collectives -------------------------------------------


def test_collectives_resolve_against_the_calling_shard():
    mesh = M.Mesh([[CPU] * 4] * 2, ("k", "x"))
    assert mesh.size == 8 and mesh.shape == {"k": 2, "x": 4}
    x = torch.arange(2 * 8, dtype=T64).reshape(2, 8)

    def f(v):
        k, i = M.axis_index("k"), M.axis_index("x")
        ring_l, ring_r = M.ring_neighbors(v[:, :1] * 0 + i, "x")
        return (M.psum(v, "x"), M.pmax(v.sum(), ("k", "x")), M.pmin(v.sum(), "k")[None],
                M.all_gather(torch.tensor([k, i]), "x")[None],
                M.ppermute(v, "x", [(j, (j + 1) % 4) for j in range(4)]),
                torch.cat([ring_l, ring_r], dim=-1), M.psum(1, ("k", "x")), M.axis_size("x"))

    out = M.shard_map(f, mesh, (M.P("k", "x"),),
                      (M.P("k", None), M.P(), M.P("x"), M.P("k"), M.P("k", "x"),
                       M.P("k", "x"), M.P(), M.P()))(x)
    blocks = x.reshape(2, 4, 2)
    assert torch.equal(out[0], blocks.sum(1))
    assert float(out[1]) == float(blocks.sum(-1).max())
    assert torch.equal(out[2], blocks.sum(-1).min(0).values)
    assert out[3].tolist() == [[[0, 0], [0, 1], [0, 2], [0, 3]], [[1, 0], [1, 1], [1, 2], [1, 3]]]
    assert torch.equal(out[4], torch.roll(blocks, 1, dims=1).reshape(2, 8))
    assert out[5][0].tolist() == [3, 1, 0, 2, 1, 3, 2, 0]
    assert out[6] == 8 and out[7] == 4


def test_reductions_run_in_shard_order_and_repeat_bitwise(rng):
    vals = rng.normal(size=(8, 5)) * 10.0 ** rng.integers(-8, 8, size=(8, 1))
    f = M.shard_map(lambda v: M.psum(v[0], "x")[None], cpu_mesh(), (M.P("x"),), M.P())
    got = [f(torch.as_tensor(vals)).numpy() for _ in range(3)]
    want = vals[0].copy()
    for row in vals[1:]:
        want = want + row
    for g in got:
        np.testing.assert_array_equal(g[0], want)


def test_a_shard_that_raises_reaches_the_caller_within_a_second():
    def f(v):
        if M.axis_index("x") == 5:
            raise ArithmeticError("shard 5 failed")
        for _ in range(3):
            v = M.psum(v, "x")
        return v

    fn = M.shard_map(f, cpu_mesh(), (M.P("x"),), M.P("x"))
    caught = []

    def call():
        try:
            fn(torch.ones(8))
        except ArithmeticError as err:
            caught.append(err)

    t0 = time.perf_counter()
    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(timeout=10.0)
    assert not th.is_alive(), "the caller hung on a failed shard"
    assert time.perf_counter() - t0 < 1.0
    assert len(caught) == 1 and "shard 5 failed" in str(caught[0])


def test_launch_counts_and_collectives_stay_exact_under_many_shards():
    """32 shards (more than this machine's cores) count launches and sum
    under a very short switch interval: a lost update would show."""
    class Wrapper:
        launches = 0

    def f(v):
        for _ in range(50):
            _build.count(Wrapper)
            v = M.psum(v, "x") * 0.0 + 1.0
        return v

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        fn = M.shard_map(f, cpu_mesh(32), (M.P("x"),), M.P("x"))
        done = []
        th = threading.Thread(target=lambda: done.append(fn(torch.zeros(32))), daemon=True)
        th.start()
        th.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not th.is_alive() and done
    assert Wrapper.launches == 32 * 50
    assert torch.equal(done[0], torch.ones(32))


def test_mesh_defaults_to_the_gpus_and_raises_without_one():
    if torch.cuda.is_available():
        assert ensemble_mesh().devices.flat[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ensemble_mesh(4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        grid_mesh()
    assert ensemble_mesh(4, device="cpu").size == 4
    with pytest.raises(ValueError, match="divide evenly"):
        M.shard_map(lambda v: v, cpu_mesh(4), (M.P("x"),), M.P("x"))(torch.ones(6))
    with pytest.raises(RuntimeError, match="outside shard_map"):
        M.psum(torch.ones(1), "x")


# -- halo, sharded diffusion, SPIKE against JAX -----------------------------


def test_neighbor_cells_halo_is_jax_bitwise(rng):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP

    from energybalancemodel_jl_tpu.ops.diffusion import neighbor_cells as jnc

    v = rng.normal(size=(3, 64))
    fn = jax.jit(shard_map(lambda a: jnc(a, "x"), mesh=jax_mesh(), in_specs=JP(None, "x"),
                           out_specs=(JP(None, "x"), JP(None, "x"))))
    want = [np.asarray(w) for w in fn(v)]
    got = M.shard_map(lambda a: neighbor_cells(a, "x"), cpu_mesh(), (M.P(None, "x"),),
                      (M.P(None, "x"), M.P(None, "x")))(torch.as_tensor(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # unsharded, the same cells: the boundary-rolled neighbours
    np.testing.assert_array_equal(got[0].numpy(), np.roll(v, 1, axis=-1))


@pytest.mark.parametrize("grid", ["sin", "identity"])
def test_sharded_diffusion_is_jax_bitwise(grid, rng):
    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.parallel.halo import grid_mesh as jgm
    from energybalancemodel_jl_tpu.parallel.halo import sharded_diffusion as jsd

    T = rng.normal(size=64) * 30.0
    want = np.asarray(jsd(getattr(ebm.SpaceTime, grid)(64, 10, 1), jgm())(T, 0.6))
    got = sharded_diffusion(getattr(ebt.SpaceTime, grid)(64, 10, 1), grid_mesh(8, device="cpu"))
    np.testing.assert_array_equal(got(torch.as_tensor(T), 0.6).numpy(), want)
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_diffusion(ebt.SpaceTime.sin(30, 10, 1), grid_mesh(8, device="cpu"))


@pytest.mark.parametrize("batch", [(), (4,)], ids=["n64", "batched-4x32"])
def test_spike_matches_jax_and_dense(batch, rng):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP

    from energybalancemodel_jl_tpu.ops.spike import spike_tridiag_solve as jspike

    n = 64 if not batch else 32
    lo, up = rng.normal(size=n), rng.normal(size=n)
    lo[0] = up[-1] = 0.0
    di = np.abs(lo) + np.abs(up) + 1.0 + (rng.uniform(0, 1, n) if not batch else 0.0)
    b = rng.normal(size=batch + (n,))
    bands = [np.broadcast_to(v, batch + (n,)).copy() for v in (lo, di, up)]
    spec = (None,) * len(batch) + ("x",)
    fn = jax.jit(shard_map(lambda *a: jspike(*a, axis_name="x"), mesh=jax_mesh(),
                           in_specs=(JP(*spec),) * 4, out_specs=JP(*spec)))
    want = np.asarray(fn(*bands, b))
    got = M.shard_map(lambda *a: tridiag_solve(*a, method="spike", axis_name="x"), cpu_mesh(),
                      (M.P(*spec),) * 4, M.P(*spec))(*(torch.as_tensor(v) for v in
                                                     (*bands, b))).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    A = np.diag(di) + np.diag(lo[1:], -1) + np.diag(up[:-1], 1)
    np.testing.assert_allclose(got, np.linalg.solve(A, b.T).T, rtol=1e-10, atol=1e-12)
    with pytest.raises(RuntimeError, match="outside shard_map"):
        spike_tridiag_solve(*(torch.as_tensor(v) for v in (*bands, b)), "x")


# -- member-sharded drivers --------------------------------------------------


def test_shard_map_year_fn_global_mean_matches_jax():
    import jax.numpy as jnp

    import energybalancemodel_jl_tpu as ebm
    from energybalancemodel_jl_tpu.parallel.sharding import shard_map_year_fn as jfn

    st = ebt.SpaceTime.sin(16, 20, 1)
    K = 8
    D = np.linspace(0.55, 0.65, K)
    par = ebt.Collection({k: np.full(K, float(v)) for k, v in
                          ebt.default_parameters("MIZ").items()}, D=D)
    jst = ebm.SpaceTime.sin(16, 20, 1)
    jcarry = {k: jnp.zeros((K, 16)) for k in ("Ei", "Ew", "h", "D", "phi", "T0")}
    _, want = jfn("MIZ", jst, jax_mesh("ensemble"), "float64")(
        jcarry, {k: jnp.asarray(v) for k, v in par.items()}, jnp.zeros(20))
    carry = ebt.Collection({k: torch.zeros((K, 16), dtype=T64) for k in jcarry})
    fn = shard_map_year_fn("MIZ", st, ensemble_mesh(8, device="cpu"), "float64")
    ptens = ebt.Collection({k: torch.as_tensor(v) for k, v in par.items()})
    new, got = fn(carry, ptens, torch.zeros(20, dtype=T64))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    assert new["Ei"].shape == (K, 16)
    # sharding changes nothing: one shard is the whole batch
    _, one = shard_map_year_fn("MIZ", st, ensemble_mesh(1, device="cpu"), "float64")(
        carry, ptens, torch.zeros(20, dtype=T64))
    assert float(one) == float(got)


@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_ensemble_integrate_mesh_is_the_unsharded_run_bitwise(model):
    st = ebt.SpaceTime.sin(16, 50, 2) if model == "MIZ" else ebt.SpaceTime.sin(16, 1000, 1)
    par = swept(8, model)
    init = ebt.zeros_init(st) if model == "MIZ" else ebt.Collection(
        E=np.full(16, 30.0), Tg=np.full(16, 30.0 / float(par["cw"])))
    kw = dict(engine="fused", dtype="float64", progress=False)
    ref = ebt.ensemble_integrate(model, st, ebt.Forcing(0.0), par, init, device="cpu", **kw)
    got = ebt.ensemble_integrate(model, st, ebt.Forcing(0.0), par, init,
                                 mesh=ensemble_mesh(4, device="cpu"), **kw)
    for store in ("avg", "winter", "summer"):
        assert same(getattr(got.seasonal, store), getattr(ref.seasonal, store)), store


def test_sharded_ensemble_integrate_is_the_batched_engine_bitwise():
    par = swept(8)
    kw = dict(dtype="float64", progress=False, raw_mode="last")
    ref = ebt.ensemble_integrate("MIZ", ST, ebt.Forcing(0.0), par, ebt.zeros_init(ST),
                                 engine="batched", device="cpu", **kw)
    got = sharded_ensemble_integrate("MIZ", ST, ebt.Forcing(0.0), par, ebt.zeros_init(ST),
                                     mesh=ensemble_mesh(4, device="cpu"), **kw)
    assert same(got.seasonal.avg, ref.seasonal.avg) and same(got.raw, ref.raw)


def test_non_divisible_member_count_warns_and_matches():
    par = swept(6)
    with pytest.warns(UserWarning, match="not divisible by mesh size 4"):
        got = sharded_ensemble_integrate("MIZ", ST, ebt.Forcing(0.0), par, ebt.zeros_init(ST),
                                         mesh=ensemble_mesh(4, device="cpu"), dtype="float64",
                                         progress=False)
    ref = ebt.ensemble_integrate("MIZ", ST, ebt.Forcing(0.0), par, ebt.zeros_init(ST),
                                 engine="batched", device="cpu", dtype="float64",
                                 progress=False)
    assert same(got.seasonal.avg, ref.seasonal.avg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a member count the mesh divides warns nothing
        sharded_ensemble_integrate("MIZ", ebt.SpaceTime.sin(8, 10, 1), ebt.Forcing(0.0),
                                   swept(4), ebt.zeros_init(ebt.SpaceTime.sin(8, 10, 1)),
                                   mesh=ensemble_mesh(4, device="cpu"), progress=False)


def test_mesh_rules_of_ensemble_integrate():
    par, init = swept(8), ebt.zeros_init(ST)
    mesh = ensemble_mesh(4, device="cpu")
    run = lambda **kw: ebt.ensemble_integrate("MIZ", ST, ebt.Forcing(0.0), par, init,
                                              progress=False, **kw)
    with pytest.raises(ValueError, match="requires engine='fused'"):
        run(mesh=mesh, engine="batched")
    with pytest.raises(ValueError, match="raw_mode='none'"):
        run(mesh=mesh, engine="fused", raw_mode="last")
    with pytest.raises(ValueError, match="not divisible by the mesh size 3"):
        run(mesh=ensemble_mesh(3, device="cpu"), engine="fused")
    with pytest.raises(ValueError, match="jit_wrapper"):
        run(engine="fused", jit_wrapper=lambda f: f, device="cpu")
    # the identity wrapper is the batched engine, bitwise
    a = run(jit_wrapper=lambda f: f, device="cpu", dtype="float64")
    b = run(engine="batched", device="cpu", dtype="float64")
    assert same(a.seasonal.avg, b.seasonal.avg)


@pytest.fixture(scope="module")
def miz_states():
    """Two MIZ states of ``ST`` (the year-end rows of zero-forced and
    +6 W/m^2-forced years) for the transition runs."""
    par = ebt.default_parameters("MIZ")
    out = []
    for F in (0.0, 6.0):
        s = ebt.integrate("MIZ", ST, ebt.Forcing(F), par, ebt.zeros_init(ST), device="cpu",
                          dtype="float64", progress=False)
        out.append({k: s.raw[k][-1] for k in ("Ei", "Ew", "h", "D", "phi")})
    return out


@pytest.mark.parametrize("engine,dtype", [("scan", "float64"), ("fused", "float32"),
                                          ("fused", "float64")])
def test_transitions_mesh_is_the_unsharded_run_bitwise(engine, dtype, miz_states):
    a, b = miz_states
    par = ebt.default_parameters("MIZ")
    kw = dict(sigma=np.linspace(1.0, 4.0, 8), tau=0.05, years=2, K=8, dtype=dtype,
              engine=engine, track=("E",), subyear=dtype == "float32")
    ref = ebt.transitions("MIZ", ST, 0.0, par, a, b, device="cpu", **kw)
    got = ebt.transitions("MIZ", ST, 0.0, par, a, b, mesh=ensemble_mesh(4, device="cpu"), **kw)
    for name in ("areas", "eta", "tracked", "state") + (("crossing_step",) if kw["subyear"]
                                                        else ()):
        g, r = getattr(got, name), getattr(ref, name)
        assert same(g, r) if isinstance(r, dict) else np.array_equal(g, r, equal_nan=True), name
    with pytest.raises(ValueError, match="not divisible by the mesh size"):
        ebt.transitions("MIZ", ST, 0.0, par, a, b, mesh=ensemble_mesh(3, device="cpu"), **kw)


def test_equilibrate_mesh_is_the_unsharded_loop_bitwise(tmp_path):
    st = ebt.SpaceTime.sin(8, 20, 1)
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=np.linspace(-2.0, 6.0, 8))
    init = ebt.zeros_init(st)
    mesh = ensemble_mesh(4, device="cpu")
    kw = dict(tol=1e-3, dtype="float64")
    ref = ebt.equilibrate("MIZ", st, 0.0, par, init, max_years=6, device="cpu",
                          engine="fused", **kw)
    got = ebt.equilibrate("MIZ", st, 0.0, par, init, max_years=6, mesh=mesh, **kw)
    assert got.years == ref.years == 6
    assert same(got.state, ref.state) and np.array_equal(got.resid, ref.resid)
    # interrupted after 3 years and resumed: the uninterrupted loop, bitwise
    ck = str(tmp_path / "eq.h5")
    ebt.equilibrate("MIZ", st, 0.0, par, init, max_years=3, mesh=mesh, checkpoint=ck, **kw)
    res = ebt.equilibrate("MIZ", st, 0.0, par, init, max_years=6, mesh=mesh, checkpoint=ck,
                          resume=True, **kw)
    assert res.years == 6 and same(res.state, got.state)
    with pytest.raises(ValueError, match="requires engine='fused'"):
        ebt.equilibrate("MIZ", st, 0.0, par, init, mesh=mesh, engine="batched", **kw)
    with pytest.raises(ValueError, match="needs an ensemble"):
        ebt.equilibrate("MIZ", st, 0.0, ebt.default_parameters("MIZ"), init, mesh=mesh, **kw)


def test_stability_and_lyapunov_mesh_are_the_unsharded_runs_bitwise():
    st = ebt.SpaceTime.sin(8, 20, 1)
    par = ebt.Collection(ebt.default_parameters("MIZ"), F=np.linspace(-2.0, 6.0, 4))
    state = ebt.equilibrate("MIZ", st, 0.0, par, ebt.zeros_init(st), tol=1e-3, max_years=3,
                            dtype="float64", device="cpu").state
    mesh = ensemble_mesh(4, device="cpu")
    for side in ("adjoint", "right"):
        kw = dict(n_iter=2, dtype="float64", side=side)
        ref = ebt.stability("MIZ", st, 0.0, par, state, device="cpu", **kw)
        got = ebt.stability("MIZ", st, 0.0, par, state, mesh=mesh, **kw)
        assert np.array_equal(got.history, ref.history), side
    kw = dict(years=1, n_modes=2, dtype="float64")
    ref = ebt.lyapunov("MIZ", st, 0.0, par, state, device="cpu", **kw)
    got = ebt.lyapunov("MIZ", st, 0.0, par, state, mesh=mesh, **kw)
    assert np.array_equal(got.history, ref.history) and same(got.state, ref.state)


def test_dryrun_multichip_on_a_cpu_mesh():
    from energybalancemodel_jl_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(2, device="cpu")


# -- the card: one kernel launch per shard per year --------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["MIZ", "Classic"])
def test_fused_year_launches_once_per_shard_and_matches_the_unsharded_year(model, cuda):
    from energybalancemodel_jl_tpu_torch.integrate import FUSED_YEARS
    from energybalancemodel_jl_tpu_torch.models.base import default_step_config, get_model

    st = ebt.SpaceTime.sin(180, 2000, 1)
    K = 64
    par = ebt.Collection({k: torch.as_tensor(v, dtype=torch.float32, device=cuda)
                          for k, v in swept(K, model).items()})
    spec = get_model(model)
    init = ebt.zeros_init(st) if model == "MIZ" else ebt.Collection(
        E=np.full(180, 30.0), Tg=np.full(180, 30.0 / float(par["cw"])))
    carry = ebt.Collection({k: v.expand(K, -1).contiguous() for k, v in
                            spec.init_carry(init, st, torch.float32, cuda).items()})
    f = torch.zeros(st.nt, dtype=torch.float32, device=cuda)
    year = FUSED_YEARS[model][0]
    ref = year(carry, par, f, st, default_step_config("float32"))
    fn = shard_map_fused_year_fn(st, ensemble_mesh(4, device=cuda), par, "float32", model=model)
    before = year.launches
    got = fn(carry, par, f)
    torch.cuda.synchronize()
    assert year.launches - before == 4
    assert same({k: v.cpu() for k, v in got[0].items()}, {k: v.cpu() for k, v in ref[0].items()})
    assert same({k: v.cpu() for k, v in got[1].avg.items()},
                {k: v.cpu() for k, v in ref[1].avg.items()})
