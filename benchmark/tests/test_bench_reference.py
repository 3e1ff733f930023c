"""The frozen reference against the port on the CPU, at a small size:
the same work count as the port's WorkCount, the same rest and
Wendland-deformed traces as the port's plain tile march, and the same
tet mesh, anchors, centres and FEM step."""
import numpy as np
import pytest
import torch

from harness import bench, brain
from reference import fem as rfem
from reference import trace as rtrace
from reference.field import Precision

W, H = 96, 64


@pytest.fixture(scope="module")
def dep():
    c = bench.resolve("brain-grid.orbit-rest")
    cfg = {**c.config, "cellsize": 0.35, "n_centers": 64, "width": W,
           "height": H}
    return brain.load(c.root, cfg, "cpu", fem=True)


def port_work(dep, ro, rd, disp=None):
    from fembrain_tpu_torch.render import tile_trace as tt

    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, H, W)
    inp = tt.prepare_tiles(dep.scene, ro_b, rd_b, disp=disp)
    count = tt.WorkCount()
    t, hit = tt._march_plain(inp, count)
    return count, tt.ray_bytes(inp.rays)


@pytest.mark.parametrize("roll", [30.0, 211.0])
def test_rest_work_and_trace_equal_the_port(dep, roll):
    from fembrain_tpu_torch.render import tile_trace as tt

    ro, rd = dep.rays(roll)
    work = rtrace.Work()
    t, hit = rtrace.trace_image(dep.ref_scene, ro, rd, H, W, work=work)
    count, n_bytes = port_work(dep, ro, rd)
    assert work.lane_evals == count.lane_evals
    assert work.flops == count.flops and work.bytes == n_bytes
    t_p, hit_p = tt.trace_tiles_image(dep.scene, ro, rd, H, W)
    assert torch.equal(hit, hit_p)
    assert float(torch.abs(t - t_p)[hit].max()) < 1e-5


def test_wendland_work_and_trace_equal_the_port(dep):
    from fembrain_tpu_torch.fem import grid_fem as gfm
    from fembrain_tpu_torch.render import deformed, tile_trace as tt

    st = dep.gf.rest_state()
    for _ in range(2):
        st, _ = gfm.timestep(dep.gf, st, dep.f_ext, cg_tol=1e-2)
    ro, rd = dep.rays(30.0)
    w_p = deformed.disp_weights_centers(dep.interp, st.q.reshape(-1, 3)[dep.cgi])
    spec = deformed.wendland_spec(dep.interp, w_p, k_refresh=4)
    t_p, hit_p = tt.trace_tiles_image(dep.scene, ro, rd, H, W, disp=spec)
    disp = dep.ref_disp(st.q.reshape(-1, 3).double(),
                        Precision(dtype=torch.float64))
    work = rtrace.Work()
    t, hit = rtrace.trace_image(dep.ref_scene, ro, rd, H, W, disp=disp,
                                work=work)
    count, _ = port_work(dep, ro, rd, spec)
    assert work.lane_evals == count.lane_evals
    assert abs(work.flops - count.flops) <= 1e-3 * count.flops
    assert torch.equal(hit, hit_p)
    assert float(torch.abs(t - t_p)[hit].max()) < 1e-4


def test_mesh_anchors_centres_and_step_equal_the_port(dep):
    from fembrain_tpu_torch.fem import grid_fem as gfm

    assert np.array_equal(dep.gf.free.cpu().numpy(), dep.ref_grid.free)
    assert np.allclose(dep.gf.mass.cpu().numpy(), dep.ref_grid.mass,
                       rtol=1e-6)
    nodes = dep.ref_grid.points.reshape(-1, 3)[dep.cgi.numpy()]
    assert np.array_equal(nodes, dep.ref_interp.centers.astype(np.float32))
    st = dep.gf.rest_state()
    st1, _ = gfm.timestep(dep.gf, st, dep.f_ext, cg_tol=1e-7)
    step = dep.ref_step(Precision(dtype=torch.float64))
    r = rfem.judge_step(step, *(x.reshape(-1, 3).double() for x in
                                (st.q, st.qvel, st1.q, st1.qvel)),
                        dep.f_ext.reshape(-1, 3).double())
    assert r["fem_energy_err"] < 1e-4 and r["fem_update_err"] < 1e-5
