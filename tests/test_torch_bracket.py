"""PyTorch port, the ray bracket (render.sphere_trace.prim_interval): on a
CPU tensor it runs the plain dense test and counts it under
`BRACKET["plain"]`, never touching the kernel library; on a CUDA tensor it
launches the bracket kernel (csrc/ray_bracket.cu).

The card tests (marked `cuda`, skip without a card) hold the kernel to
the plain version `_prim_interval_plain` under torch.equal: on the brain's
1080p block-ordered rays (padded rays included) at three rolls with the
cells' margins as 0-d device tensors, on rays with zero direction
components, on a ray count that is not a multiple of the kernel's CTA, and
on scenes of another prim count; then the tile trace's rays and image
whether its bracket came from the kernel or from the plain version:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_bracket.py
"""
import pytest
import torch

import fembrain_tpu_torch.blob.scene as pscene
from fembrain_tpu_torch import native
from fembrain_tpu_torch.blob.examples import brain_resection
from fembrain_tpu_torch.blob.reader import load_blob
from fembrain_tpu_torch.render import sphere_trace as st
from fembrain_tpu_torch.render import tile_trace as tt
from fembrain_tpu_torch.render.camera import Camera, generate_rays

from test_torch_fixtures import BRAIN, every_type

# 0.05 plus the cells' max_disp: rest, 0.5, brain-grid-k4's 1.25,
# brain-sim's 20.
MAX_DISPS = (0.0, 0.5, 1.25, 20.0)


def _brain(device):
    sc = load_blob(BRAIN)
    sc.flatten_instances()
    return sc.pack(device=device)


def _rays(device, roll, w, h):
    ro, rd = generate_rays(Camera.orbit(roll, 20.0, 8.0, device=device), w, h)
    return ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()


def _with_zero_directions(rd):
    """Some rays with one direction component exactly 0 (or -0), some
    along an axis."""
    rd = rd.clone()
    rd[::7, 0] = 0.0
    rd[3::11, 1] = -0.0
    rd[5::13, 2] = 0.0
    rd[::17, 1:] = 0.0
    return rd


# ----------------------------------------------------------------- the CPU

@pytest.fixture
def no_kernels(monkeypatch):
    """Fails the test if anything asks for the kernel library."""
    def load():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(native, "load", load)
    lib = native._lib
    yield
    assert native._lib is lib


@pytest.mark.parametrize("tensor_margin", [False, True])
def test_cpu_bracket_runs_the_plain_loop(no_kernels, monkeypatch,
                                         tensor_margin):
    """prim_interval on CPU tensors is the plain version, counted once a
    call under "plain" however many chunks it takes; no kernel is launched
    or loaded."""
    scene = _brain("cpu")
    ro, rd = _rays("cpu", 30.0, 96, 64)
    ro, rd = tt._pad_rays(ro, _with_zero_directions(rd), tt.TILE)
    margin = 0.05 + (torch.tensor(1.25) if tensor_margin else 1.25)
    want = st._prim_interval_plain(scene, ro, rd, margin)
    monkeypatch.setattr(st, "PRIM_INTERVAL_CHUNK", 1000)
    bracket, launches = dict(st.BRACKET), dict(tt.LAUNCHES)
    got = st.prim_interval(scene, ro, rd, margin)
    assert st.BRACKET == {"card": bracket["card"],
                          "plain": bracket["plain"] + 1}
    assert tt.LAUNCHES == launches
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[2].dtype == torch.bool and 0 < int(got[2].sum()) < ro.shape[0]


def test_cpu_prepare_tiles_brackets_once_in_plain(no_kernels):
    """One CPU prepare_tiles is one plain bracket; its rays carry it."""
    scene = _brain("cpu")
    ro, rd = _rays("cpu", 0.0, 64, 48)
    bracket = dict(st.BRACKET)
    inp = tt.prepare_tiles(scene, ro, rd)
    assert st.BRACKET == {"card": bracket["card"],
                          "plain": bracket["plain"] + 1}
    ro_p, rd_p = tt._pad_rays(ro, rd, tt.TILE)
    t_enter, t_exit, alive = st._prim_interval_plain(scene, ro_p, rd_p, 0.05)
    assert torch.equal(inp.rays[6], t_enter)
    assert torch.equal(inp.rays[7], t_exit)
    assert torch.equal(inp.rays[8], alive.float())


# ----------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _same_as_plain(scene, ro, rd, margin):
    before = st.BRACKET["card"]
    got = st.prim_interval(scene, ro, rd, margin)
    assert st.BRACKET["card"] == before + 1
    want = st._prim_interval_plain(scene, ro, rd, margin)
    for name, a, b in zip(("t_enter", "t_exit", "alive"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("roll", [0.0, 30.0, 137.0])
def test_kernel_equals_plain_on_1080p_block_rays(cuda, roll):
    """The brain's 1080p rays in pixel-block order, the padded rays
    included, at every cell's margin as a 0-d device tensor."""
    scene = _brain(cuda)
    ro, rd = _rays(cuda, roll, 1920, 1080)
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, 1080, 1920)
    assert ro_b.shape[0] > ro.shape[0]
    for max_disp in MAX_DISPS:
        margin = 0.05 + torch.tensor(max_disp, device=cuda)
        _, _, alive = _same_as_plain(scene, ro_b, rd_b, margin)
        assert int(alive.sum()) > 10_000
        assert not bool(alive[ro_b[:, 0] >= 1e6].any())


@pytest.mark.cuda
@pytest.mark.parametrize("scene_name", ["brain", "every_type", "resection"])
def test_kernel_equals_plain_on_zero_directions_and_odd_counts(cuda,
                                                               scene_name):
    """Zero direction components and 100,003 rays (not a multiple of 256),
    on the brain (163 prims) and on scenes of other prim counts, with the
    margin a float and a 0-d tensor."""
    scene = {"brain": lambda: _brain(cuda),
             "every_type": lambda: every_type(pscene).pack(device=cuda),
             "resection": lambda: brain_resection().pack(device=cuda),
             }[scene_name]()
    assert (scene.n_prims == 163) == (scene_name == "brain")
    ro, rd = _rays(cuda, 30.0, 400, 300)
    ro, rd = ro[:100_003], _with_zero_directions(rd[:100_003])
    for margin in (0.05, 0.05 + torch.tensor(1.25, device=cuda)):
        _same_as_plain(scene, ro, rd, margin)


@pytest.mark.cuda
@pytest.mark.parametrize("roll", [0.0, 137.0])
def test_tile_trace_same_with_either_bracket(cuda, roll, monkeypatch):
    """prepare_tiles' rays and trace_tiles_image's t and hit at 1080p are
    equal whether the bracket came from the kernel or the plain version."""
    scene = _brain(cuda)
    ro, rd = _rays(cuda, roll, 1920, 1080)
    ro_b, rd_b, _ = tt.image_rays_to_blocks(ro, rd, 1080, 1920)
    before = st.BRACKET["card"]
    rays_k = tt.prepare_tiles(scene, ro_b, rd_b).rays
    t_k, hit_k = tt.trace_tiles_image(scene, ro, rd, 1080, 1920)
    assert st.BRACKET["card"] == before + 2
    monkeypatch.setattr(tt, "prim_interval", st._prim_interval_plain)
    rays_p = tt.prepare_tiles(scene, ro_b, rd_b).rays
    t_p, hit_p = tt.trace_tiles_image(scene, ro, rd, 1080, 1920)
    assert st.BRACKET["card"] == before + 2
    assert torch.equal(rays_k, rays_p)
    assert torch.equal(t_k, t_p) and torch.equal(hit_k, hit_p)
    assert int(hit_k.sum()) > 10_000
