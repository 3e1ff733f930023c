"""Minimal rigid environment: a falling box vs floor and soft tissue.

The reference stages its demo inside a Bullet soft/rigid world — a ground
plane and a falling cube interacting with the tissue
(src/main.cpp:685-712,863-870 via SGBulletRigidMesh /
SGBulletSoftRigidDynamics). Bullet itself is out of scope (SURVEY §2.7);
this module closes the visible behavioral gap with a penalty-contact rigid
box: translation-only dynamics, analytic floor contact, and symmetric
penalty coupling against FEM tissue nodes — the box pushes contacted
nodes, the nodes push back. A 6-DOF box (quaternion orientation, box
inertia, torque from corner and tissue contacts) follows.

Counterpart of fembrain_tpu/fem/rigid.py in PyTorch: every step runs on
the device of the state it is given, in float32 like the reference's
constants; a coupled step takes its forces from the old state, then runs
the implicit FEM step (fem.integrator.timestep), then the rigid step.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import default_device

GRAVITY_Y = -10.0  # m/s^2 on the rigid body (reference world gravity)
RESTITUTION = 0.2
CONTACT_STIFFNESS = 2e4


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    """`x` (a sequence, an array or a tensor) as a tensor of `like`'s
    dtype on its device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _take(a: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(a, axis[:, None], 1)[:, 0]


@dataclasses.dataclass(frozen=True)
class RigidBoxState:
    pos: torch.Tensor  # [3] box center
    vel: torch.Tensor  # [3]

    @classmethod
    def at_rest(cls, pos, device=None):
        """At rest at `pos`, in float32 on `device` (the card when None)."""
        device = default_device() if device is None else device
        p = torch.as_tensor(pos, dtype=torch.float32, device=device)
        return cls(pos=p, vel=torch.zeros_like(p))


def box_tissue_forces(
    box_pos: torch.Tensor,
    half_extents,
    node_pos: torch.Tensor,       # [N, 3] current tissue node positions
    stiffness: float = CONTACT_STIFFNESS,
    box_vel: torch.Tensor | None = None,
    node_vel: torch.Tensor | None = None,
    damping: float = 0.0,
):
    """Symmetric penalty contact: tissue nodes inside the (axis-aligned)
    box are pushed out along their minimal-penetration axis; the box
    receives the opposite reaction. Optional velocity damping along the
    contact axis stabilizes the explicit rigid integration (a stiff
    undamped penalty pumps energy at h*omega > 2).
    Returns (f_nodes [N,3], f_box [3])."""
    he = _vec(half_extents, node_pos)
    d = node_pos - box_pos[None]
    pen = he[None] - torch.abs(d)               # [N,3] per-axis penetration
    inside = torch.all(pen > 0.0, dim=1)        # [N]
    # Minimal-penetration axis per node (ties: the first axis).
    axis = torch.argmin(pen, dim=1)             # [N]
    sign = torch.sign(_take(d, axis))
    depth = _take(pen, axis)
    mag = stiffness * depth
    if damping and box_vel is not None and node_vel is not None:
        rel = node_vel - box_vel[None]          # [N,3]
        out_rel = sign * _take(rel, axis)
        mag = mag - damping * out_rel           # oppose separation rate
    # Normalize by contact count: stiffness/damping parameterize the
    # TOTAL box-tissue interface, not per node — otherwise the effective
    # spring scales with mesh resolution and detonates the explicit box.
    count = torch.clamp(torch.sum(inside.to(mag.dtype)), min=1.0)
    mag = torch.where(inside, torch.clamp(mag, min=0.0) / count, 0.0)
    rows = torch.arange(node_pos.shape[0], device=node_pos.device)
    f_nodes = torch.zeros_like(node_pos).index_put_(
        (rows, axis), sign * mag, accumulate=True)
    f_box = -torch.sum(f_nodes, dim=0)
    return f_nodes, f_box


def rigid_step(
    state: RigidBoxState,
    half_extents,
    mass: float,
    h: float,
    f_ext: torch.Tensor | None = None,
    ground_y: float | None = None,
    gravity: float = GRAVITY_Y,
    restitution: float = RESTITUTION,
) -> RigidBoxState:
    """Symplectic-Euler step with analytic floor response (the projection
    + velocity damping the reference applies in lieu of a full solver,
    Deformable.cpp:372-396 style, here for the rigid body)."""
    he = _vec(half_extents, state.pos)
    f = _vec([0.0, gravity * mass, 0.0], state.pos)
    if f_ext is not None:
        f = f + f_ext
    vel = state.vel + (h / mass) * f
    pos = state.pos + h * vel
    if ground_y is not None:
        bottom = pos[1] - he[1]
        pen = bottom < ground_y
        pos = torch.stack([pos[0], torch.where(pen, ground_y + he[1], pos[1]),
                           pos[2]])
        vel = torch.stack([
            vel[0],
            torch.where(pen & (vel[1] < 0), -restitution * vel[1], vel[1]),
            vel[2],
        ])
    return RigidBoxState(pos=pos, vel=vel)


def coupled_box_tissue_step(
    box: RigidBoxState,
    half_extents,
    box_mass: float,
    fem_mesh,
    fem_state,
    h: float,
    ground_y: float | None = None,
    tissue_gravity: float = 0.0,
    stiffness: float = CONTACT_STIFFNESS,
):
    """One frame of the reference demo loop: box falls, contacts tissue,
    tissue deforms (implicit FEM), box feels the reaction.
    Returns (box', fem_state', cg_iters)."""
    from . import integrator as integ

    node_pos = fem_mesh.rest + fem_state.q
    # Damping ~ critical for the box-on-contact oscillator keeps the
    # explicit rigid update stable against the stiff penalty.
    damping = 2.0 * (stiffness * box_mass) ** 0.5
    f_nodes, f_box = box_tissue_forces(
        box.pos, half_extents, node_pos, stiffness,
        box_vel=box.vel, node_vel=fem_state.qvel, damping=damping,
    )
    if tissue_gravity:
        f_nodes = f_nodes + torch.stack([
            torch.zeros_like(fem_mesh.mass), tissue_gravity * fem_mesh.mass,
            torch.zeros_like(fem_mesh.mass)], 1)
    fem_state, iters = integ.timestep(fem_mesh, fem_state, f_nodes, h=h)
    box = rigid_step(
        box, half_extents, box_mass, h, f_ext=f_box, ground_y=ground_y
    )
    return box, fem_state, iters


# --------------------------------------------------------------- rotation
#
# Full 6-DOF rigid dynamics. The reference's Bullet environment
# integrates its falling cube's ORIENTATION
# (src/main.cpp:685-712,863-870 via SGBulletRigidMesh):
# quaternion state + box inertia tensor + torque from corner/tissue
# contacts.

def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (w, x, y, z) convention."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """[3, 3] rotation matrix of a unit quaternion (w, x, y, z)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def box_inertia(mass: float, half_extents) -> torch.Tensor:
    """Body-frame inertia diagonal of a solid box (float32, on the device
    of `half_extents` when it is a tensor)."""
    he = torch.as_tensor(half_extents, dtype=torch.float32)
    a, b, c = 2 * he[0], 2 * he[1], 2 * he[2]
    return (mass / 12.0) * torch.stack(
        [b * b + c * c, a * a + c * c, a * a + b * b]
    )


@dataclasses.dataclass(frozen=True)
class RigidBody6State:
    pos: torch.Tensor    # [3] center of mass
    vel: torch.Tensor    # [3]
    quat: torch.Tensor   # [4] orientation (w, x, y, z), unit
    omega: torch.Tensor  # [3] world-frame angular velocity

    @classmethod
    def at_rest(cls, pos, quat=(1.0, 0.0, 0.0, 0.0),
                omega=(0.0, 0.0, 0.0), device=None):
        """At rest at `pos` (spinning at `omega`), in float32 on `device`
        (the card when None)."""
        device = default_device() if device is None else device

        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        p = f32(pos)
        return cls(pos=p, vel=torch.zeros_like(p), quat=f32(quat),
                   omega=f32(omega))


# The 8 corners of the unit box; moved to the state's device where used.
_CORNER_SIGNS = torch.tensor(
    [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
     for sz in (-1.0, 1.0)]
)


def box_tissue_forces_6dof(
    state: RigidBody6State,
    half_extents,
    node_pos: torch.Tensor,
    stiffness: float = CONTACT_STIFFNESS,
    node_vel: torch.Tensor | None = None,
    damping: float = 0.0,
):
    """Oriented-box penalty contact: nodes are transformed into the box
    frame, pushed out along the minimal-penetration local axis; the box
    receives the opposite force AND the torque r x F about its center.
    Returns (f_nodes [N,3], f_box [3], tau_box [3])."""
    he = _vec(half_extents, node_pos)
    R = quat_to_mat(state.quat)
    d_world = node_pos - state.pos[None]
    d = d_world @ R                              # into box frame (R^T d)
    pen = he[None] - torch.abs(d)
    inside = torch.all(pen > 0.0, dim=1)
    axis = torch.argmin(pen, dim=1)
    sign = torch.sign(_take(d, axis))
    depth = _take(pen, axis)
    mag = stiffness * depth
    # local axis -> world, pointing out of the box
    n_world = R.T[axis] * sign[:, None]          # [N, 3]
    if damping and node_vel is not None:
        # contact-point velocity of the box: v + omega x r
        v_box = state.vel[None] + torch.linalg.cross(
            state.omega[None].expand_as(d_world), d_world)
        rel = node_vel - v_box
        out_rel = torch.sum(rel * n_world, -1)
        mag = mag - damping * out_rel
    count = torch.clamp(torch.sum(inside.to(mag.dtype)), min=1.0)
    mag = torch.where(inside, torch.clamp(mag, min=0.0) / count, 0.0)
    # force on the node along the outward local axis, in world frame
    f_nodes = mag[:, None] * n_world
    f_box = -torch.sum(f_nodes, dim=0)
    tau_box = -torch.sum(torch.linalg.cross(d_world, f_nodes), dim=0)
    return f_nodes, f_box, tau_box


def rigid_step_6dof(
    state: RigidBody6State,
    half_extents,
    mass: float,
    h: float,
    f_ext: torch.Tensor | None = None,
    tau_ext: torch.Tensor | None = None,
    ground_y: float | None = None,
    ground_stiffness: float = CONTACT_STIFFNESS,
    gravity: float = GRAVITY_Y,
) -> RigidBody6State:
    """Symplectic-Euler 6-DOF step. The floor is a penalty on the 8 box
    corners (each penetrating corner contributes a vertical spring +
    critical damping force AND its torque about the center — this is what
    makes a tumbling box settle flat, matching the Bullet cube's visible
    behavior). Gyroscopic term integrated explicitly; quaternion update
    q' = q + (h/2) omega*q, renormalized."""
    he = _vec(half_extents, state.pos)
    f = _vec([0.0, gravity * mass, 0.0], state.pos)
    tau = torch.zeros_like(f)
    if f_ext is not None:
        f = f + f_ext
    if tau_ext is not None:
        tau = tau + tau_ext
    R = quat_to_mat(state.quat)
    if ground_y is not None:
        signs = _CORNER_SIGNS.to(state.pos.device)
        corners_r = (signs * he[None]) @ R.T               # [8, 3] world
        corners = state.pos[None] + corners_r
        depth = torch.clamp(ground_y - corners[:, 1], min=0.0)  # [8]
        v_c = state.vel[None] + torch.linalg.cross(
            state.omega[None].expand_as(corners_r), corners_r)
        damp = 2.0 * (ground_stiffness * mass) ** 0.5
        fy = torch.where(
            depth > 0,
            ground_stiffness * depth - damp * v_c[:, 1],
            0.0,
        )
        # Normalize by the penetrating-corner count (same scheme as
        # box_tissue_forces): the effective interface stiffness/damping
        # must not scale with how many corners touch.
        n_pen = torch.clamp(torch.sum((depth > 0).to(fy.dtype)), min=1.0)
        fy = torch.clamp(fy, min=0.0) / n_pen
        fc = torch.stack(
            [torch.zeros_like(fy), fy, torch.zeros_like(fy)], -1
        )                                                   # [8, 3]
        f = f + torch.sum(fc, 0)
        tau = tau + torch.sum(torch.linalg.cross(corners_r, fc), 0)
    ib = box_inertia(mass, he)                              # body diagonal
    i_w = R @ torch.diag(ib) @ R.T
    i_w_inv = R @ torch.diag(1.0 / ib) @ R.T
    om = state.omega
    om_dot = i_w_inv @ (tau - torch.linalg.cross(om, i_w @ om))
    om2 = om + h * om_dot
    vel = state.vel + (h / mass) * f
    pos = state.pos + h * vel
    dq = 0.5 * h * quat_mul(
        torch.cat([torch.zeros_like(om2[:1]), om2]), state.quat
    )
    quat = state.quat + dq
    quat = quat / torch.linalg.norm(quat)
    return RigidBody6State(pos=pos, vel=vel, quat=quat, omega=om2)


def coupled_box_tissue_step_6dof(
    box: RigidBody6State,
    half_extents,
    box_mass: float,
    fem_mesh,
    fem_state,
    h: float,
    ground_y: float | None = None,
    tissue_gravity: float = 0.0,
    stiffness: float = CONTACT_STIFFNESS,
):
    """6-DOF variant of coupled_box_tissue_step: off-center tissue
    contacts torque the box (it tumbles), the tissue feels the oriented
    contact forces. Returns (box', fem_state', cg_iters)."""
    from . import integrator as integ

    node_pos = fem_mesh.rest + fem_state.q
    damping = 2.0 * (stiffness * box_mass) ** 0.5
    f_nodes, f_box, tau_box = box_tissue_forces_6dof(
        box, half_extents, node_pos, stiffness,
        node_vel=fem_state.qvel, damping=damping,
    )
    if tissue_gravity:
        f_nodes = f_nodes + torch.stack([
            torch.zeros_like(fem_mesh.mass), tissue_gravity * fem_mesh.mass,
            torch.zeros_like(fem_mesh.mass)], 1)
    fem_state, iters = integ.timestep(fem_mesh, fem_state, f_nodes, h=h)
    box = rigid_step_6dof(
        box, half_extents, box_mass, h, f_ext=f_box, tau_ext=tau_box,
        ground_y=ground_y,
    )
    return box, fem_state, iters
