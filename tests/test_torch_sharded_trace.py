"""PyTorch port, the rays split over ranks: trace_tiles_sharded and
trace_tiles_image_sharded (the reference's trace_pallas_sharded and
trace_pallas_image_sharded) at two gloo ranks on the CPU equal the
port's single-device trace_tiles and trace_tiles_image bit for bit (rest,
Wendland- and biharmonic-deformed), and the image form agrees with the
JAX package's sharded Pallas trace in interpret mode; the training step
over a 2 x 2 ('host', 'chip') mesh of four ranks gives the JAX package's
loss and update; initialize_distributed is a no-op for one process.

Each group of ranks starts once (`ranks` fixture, in the background while
the JAX reference compiles here) and runs every rank-side check of this
file; the rank processes import this module to find their functions, so
JAX is imported only where the reference runs."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.render import deformed as pd
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.camera import Camera, generate_rays
from fembrain_tpu_torch.parallel import sharding as sh

from test_torch_fixtures import BRAIN, small_blend

D = 2
TILE = 256
IMAGE = (26, 40)        # height, width of the small blend's image
TRAIN_RAYS = (24, 16)
LR = 1e-2


def _rays(pose, w, h, dev="cpu"):
    ro, rd = generate_rays(Camera.orbit(*pose, device=dev), w, h)
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def _scenes(dev):
    """(name, scene, rays) of each trace the ranks split."""
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    small = small_blend(pscene).pack(device=dev)
    return [("brain", sc.pack(device=dev), _rays((30.0, 20.0, 8.0), 32, 20,
                                                dev)),
            ("small", small, _rays((25.0, 20.0, 2.5), IMAGE[1], IMAGE[0],
                                   dev))]


def _disps(dev):
    """A Wendland (K2) and a biharmonic (K4) displacement of the small
    blend's neighbourhood, from a seed."""
    rng = np.random.default_rng(0)
    nodes = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    q = torch.tensor(0.02 * np.sin(nodes * 3.0), device=dev)
    out = {}
    for kind in ("wendland", "biharmonic"):
        ip = pd.build_disp_interp(nodes, n_centers=32, kernel=kind,
                                  device=dev)
        w = pd.disp_weights(ip, q)
        if kind == "wendland":
            out[kind] = pd.wendland_spec(ip, w)
        else:
            shrink, slack = pd.march_step_bounds(ip, w)
            out[kind] = pd.biharmonic_spec(ip, w, shrink, slack, 0.1, 2)
    return out


def _trace_checks(dev):
    """Two ranks on a 1-D `rays` mesh: each returns its rows; rank 0 also
    the single-device traces they are held to (computed here, beside the
    JAX reference in the test process)."""
    mesh = sh.make_mesh()
    first = sh.shard_index(mesh)[1] == 0
    out, single = {}, {}
    for name, scene, (ro, rd) in _scenes(dev):
        out[name] = tt.trace_tiles_sharded(scene, ro, rd, mesh, tile=TILE)
        if first:
            single[name] = tt.trace_tiles(scene, ro, rd, tile=TILE)
    scene, (ro, rd) = _scenes(dev)[1][1:]
    out["image"] = tt.trace_pallas_image_sharded(scene, ro, rd, *IMAGE,
                                                 mesh, tile=TILE)
    if first:
        single["image"] = tt.trace_tiles_image(scene, ro, rd, *IMAGE,
                                               tile=TILE)
    for kind, disp in _disps(dev).items():
        out[kind] = tt.trace_tiles_sharded(scene, ro, rd, mesh, tile=TILE,
                                           disp=disp)
        if first:
            single[kind] = tt.trace_tiles(scene, ro, rd, tile=TILE,
                                          disp=disp)
    out["idx"] = sh.shard_index(mesh)
    out["single"] = single
    return out


def _train_target(n):
    return np.random.default_rng(0).uniform(1.5, 2.5, n).astype(np.float32)


def _train_checks(dev):
    """Four ranks on a 2 x 2 ('host', 'chip') mesh: rays split over both
    axes, one training step, the rest trace over both axes."""
    mesh = sh.make_host_chip_mesh(2, 2)
    scene = sh.replicate(mesh, small_blend(pscene).pack(device="cpu"),
                         device=dev)
    ro, rd = _rays((25.0, 20.0, 2.5), *TRAIN_RAYS)
    target = torch.tensor(_train_target(ro.shape[0]))
    ros, rds, tg = sh.shard_rays(mesh, ro, rd, target, device=dev)
    share = sh.render_loss(scene, ros, rds, tg)
    new, loss = sh.make_train_step(LR)(scene, ros, rds, tg)
    t, hit = tt.trace_tiles_sharded(scene, ro, rd, mesh, tile=TILE)
    single = tt.trace_tiles(scene, ro, rd, tile=TILE) if (
        sh.shard_index(mesh)[1] == 0) else None
    return dict(share=float(share), loss=float(loss), t=t, hit=hit,
                single=single,
                new={k: getattr(new, k) for k in sh._float_fields(new)},
                idx=sh.shard_index(mesh), chip=sh.shard_index(mesh, "chip"))


@pytest.fixture(scope="module")
def ranks():
    """{"trace": two ranks' results, "train": four ranks'}, both groups
    launched at once; a test reads them with .result()."""
    with ThreadPoolExecutor(2) as pool:
        yield {"trace": pool.submit(sh.launch, _trace_checks, D,
                                      device="cpu"),
               "train": pool.submit(sh.launch, _train_checks, 4,
                                      device="cpu")}


# The tests that compute the JAX reference come first: the ranks finish in
# the background meanwhile.


def _joined(rs, key):
    t = torch.cat([r[key][0] for r in rs]).numpy()
    hit = torch.cat([r[key][1] for r in rs]).numpy()
    return t, hit


def test_sharded_image_trace_equals_single_device_and_jax(ranks):
    """Row-major rows of the block-coherent image trace: bit for bit the
    port's single-device trace_tiles_image, and within K1's thresholds
    (PERF.md section 2) of the JAX package's trace_pallas_image_sharded
    in interpret mode over two devices."""
    import fembrain_tpu.blob.scene as jscene
    from fembrain_tpu.parallel import sharding as jsh
    from fembrain_tpu.render.pallas_trace import trace_pallas_image_sharded

    js = small_blend(jscene).pack()
    scene, (ro, rd) = _scenes("cpu")[1][1:]
    tj, hj = trace_pallas_image_sharded(js, ro.numpy(), rd.numpy(), *IMAGE,
                                        jsh.make_mesh(D), interpret=True,
                                        tile=TILE)
    tj, hj = np.asarray(tj), np.asarray(hj)
    rs = ranks["trace"].result()
    t1, h1 = rs[0]["single"]["image"]
    t, hit = _joined(rs, "image")
    np.testing.assert_array_equal(hit, h1.numpy())
    np.testing.assert_array_equal(t, t1.numpy())
    assert (hit == hj).mean() > 0.999, (hit != hj).sum()
    both = hit & hj
    assert both.sum() > 20
    assert np.abs(t[both] - tj[both]).max() < 1e-4


def _jax_train():
    import jax
    import jax.numpy as jnp

    import fembrain_tpu.blob.scene as jscene
    from fembrain_tpu.parallel import sharding as jsh
    from fembrain_tpu.render.camera import Camera as JCamera
    from fembrain_tpu.render.camera import generate_rays as jrays

    js = small_blend(jscene).pack()
    ro, rd = jrays(JCamera.orbit(25.0, 20.0, 2.5), *TRAIN_RAYS)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    target = jnp.asarray(_train_target(ro.shape[0]))
    hc = jsh.make_host_chip_mesh(2, 2)
    ros, rds, tg = jsh.shard_rays(hc, ro, rd, target)
    new, loss = jax.jit(jsh.make_train_step(LR))(jsh.replicate(hc, js),
                                                  ros, rds, tg)
    return js, new, float(loss)


def test_train_step_on_host_chip_mesh_matches_jax(ranks):
    """Four ranks, rays split over host and chip: the loss shares sum to
    the JAX package's mean loss within 1e-5, every rank holds the same
    updated scene, and its update (the all-reduced gradient) is the JAX
    package's."""
    js, jnew, jloss = _jax_train()
    rs = ranks["train"].result()
    assert [r["idx"] for r in rs] == [(4, i) for i in range(4)]
    assert [r["chip"] for r in rs] == [(2, 0), (2, 1), (2, 0), (2, 1)]
    assert abs(sum(r["share"] for r in rs) - jloss) <= 1e-5 * jloss
    for r in rs:
        assert abs(r["loss"] - jloss) <= 1e-5 * jloss
    moved = 0
    for k, v in rs[0]["new"].items():
        for r in rs[1:]:
            assert torch.equal(r["new"][k], v), k
        old = np.asarray(getattr(js, k))
        g = (old - v.numpy()) / LR
        g_ref = (old - np.asarray(getattr(jnew, k))) / LR
        tol = 1e-3 * max(np.abs(g_ref).max(), 1e-6)
        np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=tol, err_msg=k)
        moved += int(np.abs(g_ref).max() > 0)
    assert moved >= 3


@pytest.mark.parametrize("name", ["brain", "small"])
def test_sharded_rest_trace_equals_single_device(ranks, name):
    rs = ranks["trace"].result()
    assert [r["idx"] for r in rs] == [(D, 0), (D, 1)]
    t1, h1 = rs[0]["single"][name]
    t, hit = _joined(rs, name)
    np.testing.assert_array_equal(hit, h1.numpy())
    np.testing.assert_array_equal(t, t1.numpy())
    assert hit.sum() > 20
    # the last rank's rows lose the padding, the first ones are whole tiles
    assert len(rs[0][name][0]) % TILE == 0


@pytest.mark.parametrize("kind", ["wendland", "biharmonic"])
def test_sharded_deformed_trace_equals_single_device(ranks, kind):
    """The displacement spec is replicated, the rays split (K2, K4)."""
    rs = ranks["trace"].result()
    t1, h1 = rs[0]["single"][kind]
    t, hit = _joined(rs, kind)
    np.testing.assert_array_equal(hit, h1.numpy())
    np.testing.assert_array_equal(t, t1.numpy())
    assert hit.sum() > 20


def test_host_chip_rest_trace_equals_single_device(ranks):
    rs = ranks["train"].result()
    t1, h1 = rs[0]["single"]
    t, hit = (torch.cat([r[k] for r in rs]).numpy() for k in ("t", "hit"))
    np.testing.assert_array_equal(hit, h1.numpy())
    np.testing.assert_array_equal(t, t1.numpy())


def test_initialize_distributed_is_a_no_op_for_one_process():
    assert sh.initialize_distributed() == 1
    assert sh.initialize_distributed(num_processes=1, process_id=0) == 1
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,per_card,backend", [
    ("cpu", 1, "gloo"), ("cuda", 1, "nccl"), ("cuda", 2, "gloo")])
def test_transport_follows_the_compute_device(device, per_card, backend):
    """NCCL when every rank computes on a card of its own; gloo for CPU
    ranks and for ranks that share a card (NCCL refuses them)."""
    assert sh._backend(torch.device(device), per_card) == backend


def test_pad_to_multiple_and_row_share():
    a = torch.arange(10.0).reshape(5, 2)
    p, n = sh.pad_to_multiple(a, 4)
    assert n == 5 and p.shape == (8, 2) and not p[5:].any()
    assert sh.pad_to_multiple(a, 5)[0] is a
    # 1000 rays over 3 ranks in whole tiles of 256: 512 + 488 + 0 rows
    rows = [sh.row_share(1000, 3, i, 256) for i in range(3)]
    assert [(r.start, r.stop) for r in rows] == [(0, 512), (512, 1000),
                                                  (1000, 1000)]
