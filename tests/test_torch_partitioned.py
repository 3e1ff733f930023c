"""PyTorch port, the FEM split over ranks: fem.sharded (tets split, state
replicated, one all_reduce per assembly) and fem.partitioned (nodes
split, two halo shifts and two scalar all_reduces a CG iteration) at two
gloo ranks on the CPU, against the JAX functions on the 8-device CPU
mesh and against the port's single-device integrator.timestep, on the
same numpy meshes and forces.

The ranks start once (`ranks` fixture, in the background while the JAX
reference compiles here) and run every rank-side check of this file; the
rank processes import this module to find `_rank_checks`, so JAX is
imported only where the reference runs, in this process."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fembrain_tpu_torch.fem import integrator as pinteg
from fembrain_tpu_torch.fem import partitioned as ppt
from fembrain_tpu_torch.fem import sharded as psh
from fembrain_tpu_torch.fem.tetmesh import build_fem_mesh
from fembrain_tpu_torch.mesh import samples
from fembrain_tpu_torch.parallel import sharding as sh

D = 2


def _cube():
    nodes, tets = samples.truth_cube(6, 6, 6, 0.1)
    nodes, tets = np.asarray(nodes), np.asarray(tets)
    return nodes, tets, np.asarray(samples.bottom_nodes(nodes))


def _bar(n=24, cell=0.08):
    nodes, tets = samples.truth_cube(n, 2, 2, cell)
    nodes, tets = np.asarray(nodes), np.asarray(tets)
    return nodes, tets, np.asarray(samples.bottom_nodes(nodes))


def _shuffled():
    """A 10x2x2 bar with its node ids shuffled (what a cut leaves)."""
    nodes, tets = samples.truth_cube(10, 2, 2, 0.1)
    nodes, tets = np.asarray(nodes), np.asarray(tets)
    perm = np.random.default_rng(7).permutation(len(nodes))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    fixed = np.sort(inv[np.asarray(samples.bottom_nodes(nodes))])
    return nodes[perm], inv[tets], fixed


def _gravity(n, fy):
    f = np.zeros((n, 3), np.float32)
    f[:, 1] = fy
    return f


def _rank_checks(dev):
    """Every rank-side check of this file, on one rank; returns its
    blocks and counts (on the CPU)."""
    out = {}
    pmesh = sh.make_mesh(axis=ppt.NODE_AXIS)

    def part_step(nodes, tets, fixed, f, steps, h, dv_warm=True, **kw):
        pm = ppt.build_partitioned(nodes, tets, D, fixed=fixed, device=dev)
        fp = ppt.to_partition_order(pm, torch.tensor(f))[pm.part]
        q = v = dv = torch.zeros_like(fp)
        qs, its, counts = [], [], []
        for _ in range(steps):
            sh.reset_counts()
            q, v, dv2, it = ppt.partitioned_timestep(
                pm, pmesh, q, v, fp, h=h, dv=dv if dv_warm else None, **kw)
            dv = dv2
            counts.append(dict(sh.COUNTS))
            qs.append(q.cpu())
            its.append(it)
        return dict(q=qs, iters=its, counts=counts, part=pm.part)

    nodes, tets, fixed = _cube()
    out["cube"] = part_step(nodes, tets, fixed,
                            _gravity(len(nodes), -1000.0), 1, 0.0333)
    nodes, tets, fixed = _bar()
    out["warm"] = part_step(nodes, tets, fixed,
                            _gravity(len(nodes), -800.0), 3, 0.01)
    nodes, tets, fixed = _shuffled()
    out["shuffled"] = part_step(nodes, tets, fixed,
                                _gravity(len(nodes), -500.0), 1, 0.01)

    # differentiable: d sum(q^2) / d(force scale), the scale held whole
    nodes, tets, fixed = _bar(8, 0.1)
    pm = ppt.build_partitioned(nodes, tets, D, fixed=fixed, device=dev)
    fp = ppt.to_partition_order(
        pm, torch.tensor(_gravity(len(nodes), -500.0)))[pm.part]
    z = torch.zeros_like(fp)

    def loss(scale):
        q, _, _, it = ppt.partitioned_timestep(
            pm, pmesh, z, z, fp * sh.replicated(scale), h=0.01,
            differentiable=True)
        return torch.sum(q * q), it

    scale = torch.tensor(1.0, requires_grad=True)
    lv, it = loss(scale)
    lv.backward()
    with torch.no_grad():
        lp = sh.all_reduce(loss(torch.tensor(1.001))[0])
        lm = sh.all_reduce(loss(torch.tensor(0.999))[0])
    out["grad"] = dict(g=float(scale.grad), it=it,
                       fd=float((lp - lm) / 0.002))

    # fem.sharded: tets split, the state whole on every rank; float32,
    # then the same step in float64
    cn, ct = samples.truth_cube(4, 4, 4, 0.4)
    cn, ct = np.asarray(cn), np.asarray(ct)
    tmesh = psh.make_tet_mesh_axis()
    for key, dtype in (("sharded", torch.float32),
                       ("sharded64", torch.float64)):
        mesh = build_fem_mesh(cn, ct, fixed=samples.bottom_nodes(cn),
                              E=1e6, dtype=dtype, device=dev)
        local = psh.place_sharded(psh.pad_mesh_for_sharding(mesh, D), tmesh)
        f = torch.tensor(_gravity(len(cn), -500.0), dtype=dtype, device=dev)
        sh.reset_counts()
        st, it = psh.sharded_timestep(local, tmesh,
                                      pinteg.FemState.rest(mesh), f, h=0.02)
        out[key] = dict(q=st.q.cpu(), qvel=st.qvel.cpu(), iters=it,
                        counts=dict(sh.COUNTS), n_tets=local.n_tets)
    return out


@pytest.fixture(scope="module")
def ranks():
    """The ranks' results, launched in the background: a test reads them
    with .result()."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(sh.launch, _rank_checks, D, device="cpu")


def _stack(ranks, key, i=-1):
    """The ranks' blocks of a run, stacked [D, Nl, 3] in rank order."""
    ranks = ranks.result()
    assert [r[key]["part"] for r in ranks] == list(range(D))
    return np.stack([r[key]["q"][i].numpy() for r in ranks])


def _jax_partitioned(nodes, tets, fixed, f, steps, h, warm=True):
    """The JAX package's partitioned trajectory: [D, Nl, 3] blocks and
    CG counts per step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fembrain_tpu.fem import partitioned as jpt

    pm = jpt.build_partitioned(nodes, tets, D, fixed=fixed)
    dm = Mesh(np.array(jax.devices()[:D]), (jpt.NODE_AXIS,))
    fp = jpt.to_partition_order(pm, jnp.asarray(f))
    step = jax.jit(lambda q, v, dv: jpt.partitioned_timestep(
        pm, dm, q, v, fp, h=h, dv=dv))
    q = v = dv = jnp.zeros_like(fp)
    qs, its = [], []
    for _ in range(steps):
        q, v, dv2, it = step(q, v, dv)
        dv = dv2 if warm else jnp.zeros_like(fp)
        qs.append(np.asarray(q))
        its.append(int(it))
    return pm, qs, its


def _port_single(nodes, tets, fixed, f, steps, h):
    mesh = build_fem_mesh(nodes, tets, fixed=fixed, device="cpu")
    st = pinteg.FemState.rest(mesh)
    for _ in range(steps):
        st, _ = pinteg.timestep(mesh, st, torch.tensor(f), h=h)
    return st.q.numpy()


def test_partitioned_step_matches_jax_and_single_device(ranks):
    nodes, tets, fixed = _cube()
    f = _gravity(len(nodes), -1000.0)
    jpm, jq, jit = _jax_partitioned(nodes, tets, fixed, f, 1, 0.0333)
    np.testing.assert_array_equal(
        ppt.build_partitioned(nodes, tets, D, fixed=fixed,
                              device="cpu").perm.numpy(), np.asarray(jpm.perm))
    got = _stack(ranks, "cube")
    np.testing.assert_allclose(got, jq[0], rtol=1e-4, atol=1e-7)
    rs = ranks.result()
    assert abs(rs[0]["cube"]["iters"][0] - jit[0]) <= 1
    assert rs[0]["cube"]["iters"] == rs[1]["cube"]["iters"]
    pm = ppt.build_partitioned(nodes, tets, D, fixed=fixed, device="cpu")
    q = ppt.from_partition_order(pm, torch.tensor(got)).numpy()
    ref = _port_single(nodes, tets, fixed, f, 1, 0.0333)
    np.testing.assert_allclose(q, ref, rtol=1e-4, atol=1e-7)
    assert np.abs(ref).max() > 1e-3


def test_three_warm_started_steps(ranks):
    """A 24x2x2 bar, dv carried from step to step: the blocks track the
    JAX trajectory and the single-device warm-started one."""
    nodes, tets, fixed = _bar()
    f = _gravity(len(nodes), -800.0)
    _, jq, jit = _jax_partitioned(nodes, tets, fixed, f, 3, 0.01)
    for i in range(3):
        np.testing.assert_allclose(_stack(ranks, "warm", i), jq[i],
                                   rtol=1e-4, atol=1e-7)
        its = ranks.result()[0]["warm"]["iters"]
        assert abs(its[i] - jit[i]) <= 1, (its, jit)
    pm = ppt.build_partitioned(nodes, tets, D, fixed=fixed, device="cpu")
    q = ppt.from_partition_order(pm, torch.tensor(_stack(ranks, "warm")))
    np.testing.assert_allclose(q.numpy(),
                               _port_single(nodes, tets, fixed, f, 3, 0.01),
                               rtol=1e-3, atol=1e-6)


def test_collectives_per_cg_iteration(ranks):
    """Per CG iteration two halo shifts (the matvec's exchange and
    collect) and two scalar all_reduces (the dots); the set-up's five
    shifts (q, qvel, forces, K qvel, the Jacobi blocks), the warm start's
    matvec (two) and two dots. Nothing is gathered."""
    r0 = ranks.result()[0]
    for key in ("cube", "warm", "shuffled"):
        for c, it in zip(r0[key]["counts"], r0[key]["iters"]):
            assert c["shift"] == 2 * it + 7, (key, c, it)
            assert c["all_reduce"] == 2 * it + 2, (key, c, it)
            assert c["all_gather"] == 0


def _spiral():
    """An 80x2x2 bar wound 1.5 times into a flat spiral, its node ids
    shuffled: at 8 parts no coordinate sort keeps every tet within two
    adjacent blocks, the RCM ordering does."""
    nodes, tets = samples.truth_cube(80, 2, 2, 0.1)
    nodes, tets = np.asarray(nodes, np.float64), np.asarray(tets)
    th = nodes[:, 0] / nodes[:, 0].max() * 3.0 * np.pi
    r = 1.0 + 0.5 * th / (2 * np.pi) + nodes[:, 2]
    wound = np.stack([r * np.cos(th), nodes[:, 1], -r * np.sin(th)], 1)
    perm = np.random.default_rng(3).permutation(len(nodes))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return wound[perm], inv[tets]


def test_rcm_and_shuffled_ids():
    """Shuffled node ids still build (a coordinate sort splits them) and
    solve equal to the single-device step (checked in the ranks); where
    no coordinate sort splits (the wound bar at 8 parts), both packages
    fall back to the same RCM ordering, which keeps the adjacency
    invariant."""
    from fembrain_tpu.fem import partitioned as jpt

    nodes, tets, fixed = _shuffled()
    np.testing.assert_array_equal(
        ppt.build_partitioned(nodes, tets, D, fixed=fixed,
                              device="cpu").perm.numpy(),
        np.asarray(jpt.build_partitioned(nodes, tets, D, fixed=fixed).perm))
    nodes, tets = _spiral()
    n, parts = len(nodes), 8
    for a in range(3):
        inv = np.empty(n, np.int64)
        inv[np.argsort(nodes[:, a], kind="stable")] = np.arange(n)
        assert not ppt._split_ok(inv[tets], -(-n // parts), parts)
    order = ppt._rcm_order(n, tets.astype(np.int64))
    np.testing.assert_array_equal(order, jpt._rcm_order(n, tets))
    got = ppt.build_partitioned(nodes, tets, parts, device="cpu", part=5)
    np.testing.assert_array_equal(got.perm.numpy(), order)
    np.testing.assert_array_equal(
        got.perm.numpy(), np.asarray(jpt.build_partitioned(nodes, tets,
                                                           parts).perm))


def test_shuffled_mesh_step_matches_single_device(ranks):
    nodes, tets, fixed = _shuffled()
    f = _gravity(len(nodes), -500.0)
    pm = ppt.build_partitioned(nodes, tets, D, fixed=fixed, device="cpu")
    q = ppt.from_partition_order(pm, torch.tensor(_stack(ranks, "shuffled")))
    np.testing.assert_allclose(q.numpy(),
                               _port_single(nodes, tets, fixed, f, 1, 0.01),
                               rtol=1e-4, atol=1e-7)


def test_too_many_parts_raises_in_both_packages():
    from fembrain_tpu.fem import partitioned as jpt

    nodes, tets = samples.truth_cube(3, 3, 3, 0.1)
    with pytest.raises(ValueError):
        jpt.build_partitioned(nodes, tets, 8)
    with pytest.raises(ValueError):
        ppt.build_partitioned(nodes, tets, 8, device="cpu")


def test_differentiable_gradient_across_ranks(ranks):
    """d sum(q^2) / d(force scale) through the split adjoint solve: the
    same on both ranks (the scale's gradient is summed over them), equal
    to the JAX package's within 1e-3 and to central differences."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fembrain_tpu.fem import partitioned as jpt

    nodes, tets, fixed = _bar(8, 0.1)
    pm = jpt.build_partitioned(nodes, tets, D, fixed=fixed)
    dm = Mesh(np.array(jax.devices()[:D]), (jpt.NODE_AXIS,))
    z = jpt.to_partition_order(pm, jnp.zeros((len(nodes), 3)))
    fp = jpt.to_partition_order(pm, jnp.asarray(_gravity(len(nodes),
                                                         -500.0)))

    def loss(scale):
        q, _, _, _ = jpt.partitioned_timestep(pm, dm, z, z, fp * scale,
                                              h=0.01, differentiable=True)
        return jnp.sum(q * q)

    g_jax = float(jax.jit(jax.grad(loss))(1.0))
    rs = ranks.result()
    g = [r["grad"]["g"] for r in rs]
    assert g[0] == g[1] and rs[0]["grad"]["it"] == -1
    assert abs(g[0] - g_jax) <= 1e-3 * abs(g_jax), (g[0], g_jax)
    np.testing.assert_allclose(g[0], rs[0]["grad"]["fd"], rtol=2e-3)


def test_sharded_tets_match_jax_and_single_device(ranks):
    """fem.sharded: each rank's half of the (padded) tets, the state
    replicated: equal on both ranks, to the JAX package's sharded step
    and to the single-device step; forces, K qvel, the diagonal and one
    all_reduce per CG iteration; in float64 the CG counts equal."""
    import jax
    import jax.numpy as jnp

    from fembrain_tpu.fem import integrator as jinteg
    from fembrain_tpu.fem import sharded as jsh
    from fembrain_tpu.fem.tetmesh import build_fem_mesh as jbuild

    cn, ct = samples.truth_cube(4, 4, 4, 0.4)
    cn, ct = np.asarray(cn), np.asarray(ct)
    f = _gravity(len(cn), -500.0)
    dm = jsh.make_tet_mesh_axis(D)

    def jax_step(dtype):
        jm = jbuild(cn, ct, fixed=samples.bottom_nodes(cn), E=1e6,
                    dtype=dtype)
        jm_p = jsh.place_sharded(jsh.pad_mesh_for_sharding(jm, D), dm)
        return jsh.sharded_timestep(jm_p, dm, jinteg.FemState.rest(jm),
                                    jnp.asarray(f, dtype), h=0.02)

    jst, jit = jax_step(jnp.float32)
    with jax.enable_x64(True):
        _, jit64 = jax_step(jnp.float64)
        jit64 = int(jit64)
    r0, r1 = (r["sharded"] for r in ranks.result())
    np.testing.assert_array_equal(r0["q"].numpy(), r1["q"].numpy())
    assert r0["n_tets"] * D >= len(ct) and r0["iters"] == r1["iters"]
    np.testing.assert_allclose(r0["q"].numpy(), np.asarray(jst.q),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r0["qvel"].numpy(), np.asarray(jst.qvel),
                               rtol=1e-4, atol=1e-6)
    # Point-Jacobi CG at tol 1e-6 on this cube: the JAX package counts 53
    # in float32 at 1, 2, 4 and 8 devices, the port 51. In float64 both
    # count 49: the two algorithms agree and the float32 counts differ by
    # rounding (the JAX package's float32 dots round more), so two apart.
    r64 = ranks.result()[0]["sharded64"]
    assert r64["iters"] == jit64, (r64["iters"], jit64)
    assert abs(r0["iters"] - int(jit)) <= 2, (r0["iters"], int(jit))
    mesh = build_fem_mesh(cn, ct, fixed=samples.bottom_nodes(cn), E=1e6,
                          device="cpu")
    st, _ = pinteg.timestep(mesh, pinteg.FemState.rest(mesh),
                            torch.tensor(f), h=0.02)
    np.testing.assert_allclose(r0["q"].numpy(), st.q.numpy(), rtol=1e-4,
                               atol=1e-6)
    c = r0["counts"]
    assert c["all_reduce"] == r0["iters"] + 3 and c["shift"] == 0, c
