"""The rigid-body stage of a physics substep on the CPU: sim/tengine.py
`rigid_body_plain` and `rigid_body`, ops/rigid_body.py and the source of its
CUDA kernel, ops/csrc/rigid_body.cu.

* `rigid_body_plain` equals, bit for bit, the frozen plain reference's
  `_fk` + `_mass_matrix_and_bias` (portbench/reference/sim/tengine.py) with
  its substep's geom and joint-limit lines written out here, for N in
  {1, 7, 64}, on states with joints beyond both limits and randomised mass,
  COM and inertia.
* `rigid_body` on CPU tensors takes the plain path and never launches the
  kernel; `rigid_body_cuda` refuses fp64, wrong shapes and other layouts.
* The kernel's source compiled for the host with g++ (its
  `rigid_body_host` runs both phases of every block in order) against
  `rigid_body_plain`. On the card the kernel gives the plain version's
  results bit for bit: it rounds every product on its own and adds the
  terms of each small contraction in the order in which the card's
  torch.sum adds them. So the host build equals, bit for bit, the plain
  version run with torch.sum adding in that order (`card_sum`) and with
  libm's sinf and cosf, which the host build calls; against the plain
  version as the CPU runs it (other summation orders) every output lies
  within 1e-5 of its largest magnitude (fp32 rounding: ~1e-7 here).

The tengine-vs-N-major and JAX parity tests keep guarding `_substep`.
"""
import ctypes
import ctypes.util
import shutil
import subprocess

import numpy as np
import pytest
import torch

from go2_rl_gym_tpu_torch.ops import cuda_build
from go2_rl_gym_tpu_torch.ops import rigid_body as rb
from go2_rl_gym_tpu_torch.sim import engine as te
from go2_rl_gym_tpu_torch.sim import tengine as tt
from go2_rl_gym_tpu_torch.sim.model import go2_model
from portbench.reference.sim import engine as ref_engine
from portbench.reference.sim import tengine as ref
from portbench.reference.sim import tmath as ref_tm
from portbench.reference.sim.model import go2_model as ref_go2_model

OUTPUTS = ("gpos", "gvel", "jpos", "axis_w", "Rbase", "rhs0", "B", "Dinv",
           "Sinv")


@pytest.fixture(scope="module")
def setup():
    model = go2_model()
    layout = te.quad_layout(model)
    params = te.SimParams()
    return model, layout, params, tt._static(model, layout, "cpu",
                                             params.gravity)


def _inputs(model, N, seed):
    """A T-layout state with a third of the joints below their lower limit
    and a third above their upper one, PD torques, damping, and per-env
    mass, COM and inertia randomised as the env's DR does and beyond."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g)

    def rand(*shape):
        return torch.rand(shape, generator=g)
    quat = randn(4, N)
    quat = quat / quat.norm(dim=0)
    lo = torch.as_tensor(model.dof_lower, dtype=torch.float32)[:, None]
    hi = torch.as_tensor(model.dof_upper, dtype=torch.float32)[:, None]
    inside = lo + (hi - lo) * rand(12, N)
    side = torch.randint(0, 3, (12, N), generator=g)
    q = torch.where(side == 0, lo - 0.3 * rand(12, N),
                    torch.where(side == 1, hi + 0.3 * rand(12, N), inside))
    s = tt.TState(pos=randn(3, N), quat=quat, q=q, lin=randn(3, N),
                  ang=randn(3, N, scale=2.0), qd=randn(12, N, scale=5.0))
    tau = randn(12, N, scale=10.0)
    kd = 0.3 + rand(12, N)
    f32 = dict(dtype=torch.float32)
    mass = (torch.as_tensor(model.mass, **f32)[:, None]
            * (0.7 + 0.6 * rand(13, N)))
    com = (torch.as_tensor(model.com, **f32)[:, :, None]
           + 0.02 * randn(13, 3, N))
    inertia = (torch.as_tensor(model.inertia, **f32)[:, :, :, None]
               * (0.7 + 0.6 * rand(13, 1, 1, N)))
    dyn_t = dict(mass=mass.contiguous(), com=com.contiguous(),
                 inertia=inertia.contiguous())
    return s, tau, kd, dyn_t


def _reference(s, tau, kd, dyn_t):
    """The frozen reference's substep up to the contact stage, its lines
    written out: `_fk`, the geoms, the joint-limit spring,
    `_mass_matrix_and_bias` and tau_gen - bias."""
    model = ref_go2_model()
    layout = ref_engine.quad_layout(model)
    params = ref_engine.SimParams()
    st = ref._static(model, layout, "cpu", params.gravity)
    s = ref.TState(*s)
    dt = params.dt
    N = s.pos.shape[-1]
    R, p, w, vlin, axis_w, jpos = ref._fk(layout, s, st)
    gb = st.geom_body
    G = gb.shape[0]
    Rg = R[gb]
    arm = ref_tm.mv(Rg, st.geom_offset.expand(G, 3, N))
    gpos = p[gb] + arm
    gvel = vlin[gb] + ref_tm.cross(w[gb], arm)
    viol_lo = torch.clamp(st.dof_lower - s.q, min=0.0)
    viol_hi = torch.clamp(s.q - st.dof_upper, min=0.0)
    in_viol = ((viol_lo > 0) | (viol_hi > 0)).to(torch.float32)
    tau_tot = (tau + params.joint_limit_stiffness * (viol_lo - viol_hi)
               - params.joint_limit_stiffness * dt * s.qd * in_viol)
    damping_eff = kd + in_viol * (
        params.joint_limit_stiffness * dt + params.joint_limit_damping)
    si, bias, Rbase = ref._mass_matrix_and_bias(layout, params, dyn_t, s,
                                                damping_eff, st)
    tau_gen = torch.cat([torch.zeros((6, N)), tau_tot], dim=0)
    return (gpos, gvel, jpos, axis_w, Rbase, tau_gen - bias, si.B, si.Dinv,
            si.Sinv)


def _flat(out: tt.RigidBody):
    return (out.gpos, out.gvel, out.jpos, out.axis_w, out.Rbase, out.rhs0,
            out.si.B, out.si.Dinv, out.si.Sinv)


@pytest.mark.parametrize("N", [1, 7, 64])
def test_plain_equals_frozen_reference(setup, N):
    model, layout, params, st = setup
    s, tau, kd, dyn_t = _inputs(model, N, seed=N)
    got = _flat(tt.rigid_body_plain(layout, params, dyn_t, s, tau, kd, st))
    want = _reference(s, tau, kd, dyn_t)
    # the states reach both limits, so the spring is exercised both ways
    assert bool((s.q < st.dof_lower).any())
    assert bool((s.q > st.dof_upper).any())
    for name, a, b in zip(OUTPUTS, got, want):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_cpu_path_launches_nothing(setup):
    model, layout, params, st = setup
    s, tau, kd, dyn_t = _inputs(model, 5, seed=3)
    before = dict(rb.LAUNCHES)
    out = tt.rigid_body(layout, params, dyn_t, s, tau, kd, st)
    plain = tt.rigid_body_plain(layout, params, dyn_t, s, tau, kd, st)
    for name, a, b in zip(OUTPUTS, _flat(out), _flat(plain)):
        assert torch.equal(a, b), name
    # a whole decimated physics step on the CPU launches nothing either
    terrain = te.flat_terrain()
    step = tt.make_physics_step(model, params, terrain, 4)
    N = 5
    state = tt.from_t(s)
    dyn = te.DynParams(mass=dyn_t["mass"].T.contiguous(),
                       com=torch.movedim(dyn_t["com"], -1, 0).contiguous(),
                       inertia=torch.movedim(dyn_t["inertia"], -1, 0)
                       .contiguous(),
                       friction=torch.ones(N), restitution=torch.zeros(N))
    ones = torch.ones((N, 12))
    step(dyn, state, torch.zeros((4, N, 12)), 20.0 * ones, 0.5 * ones, ones,
         0.0 * ones)
    assert rb.LAUNCHES == before


def _cuda_args(setup, N=6):
    model, layout, params, st = setup
    s, tau, kd, dyn_t = _inputs(model, N, seed=11)
    return dict(state=tuple(s), tau=tau, damping=kd, mass=dyn_t["mass"],
                com=dyn_t["com"], inertia=dyn_t["inertia"],
                table=st.rb_table, itable=st.rb_itable,
                scalars=[0.005, 1e-3, 300.0, 1.5, 3.5])


def test_wrapper_refuses_what_the_kernel_cannot_take(setup):
    args = _cuda_args(setup)
    before = dict(rb.LAUNCHES)
    # fp64 anywhere
    bad = dict(args, tau=args["tau"].double())
    with pytest.raises(TypeError):
        rb.rigid_body_cuda(**bad)
    bad = dict(args, state=(args["state"][0].double(),) + args["state"][1:])
    with pytest.raises(TypeError):
        rb.rigid_body_cuda(**bad)
    # wrong shapes: the N-major state, a missing leg, another env count
    bad = dict(args, state=(args["state"][0].T,) + args["state"][1:])
    with pytest.raises(ValueError, match="pos"):
        rb.rigid_body_cuda(**bad)
    bad = dict(args, damping=args["damping"][:9])
    with pytest.raises(ValueError, match="damping"):
        rb.rigid_body_cuda(**bad)
    bad = dict(args, mass=args["mass"][:, :5].contiguous())
    with pytest.raises(ValueError, match="mass"):
        rb.rigid_body_cuda(**bad)
    # another layout: N-major dynamics parameters seen batch-last
    com_nm = args["com"].permute(2, 0, 1).contiguous()
    bad = dict(args, com=torch.movedim(com_nm, 0, -1))
    with pytest.raises(ValueError, match="contiguous"):
        rb.rigid_body_cuda(**bad)
    # tables of another geom count, or of int64
    bad = dict(args, itable=args["itable"][:-1])
    with pytest.raises(ValueError, match="itable"):
        rb.rigid_body_cuda(**bad)
    bad = dict(args, itable=args["itable"].long())
    with pytest.raises(ValueError, match="itable"):
        rb.rigid_body_cuda(**bad)
    # well-formed CPU tensors: the kernel runs on a card only
    with pytest.raises(ValueError, match="CUDA"):
        rb.rigid_body_cuda(**args)
    assert rb.LAUNCHES == before


def test_tables_take_four_legs_of_three_joints_only():
    model = go2_model()
    layout = te.quad_layout(model)
    table, itable = rb.tables(layout.axes, layout.origins, model.dof_lower,
                              model.dof_upper, [0.0, 0.0, -9.81],
                              model.geom_body, model.geom_offset, "cpu")
    G = len(model.geom_body)
    assert table.shape == (99 + 3 * G,) and itable.shape == (14 + G,)
    start, order = itable[:14].numpy(), itable[14:].numpy()
    # each body's geoms, in their own order
    gb = np.asarray(model.geom_body)
    for b in range(13):
        want = list(np.flatnonzero(gb == b))
        assert list(order[start[b]:start[b + 1]]) == want
    with pytest.raises(ValueError, match="4 legs of 3 joints"):
        rb.tables(layout.axes[:3], layout.origins[:3], model.dof_lower,
                  model.dof_upper, [0.0, 0.0, -9.81], model.geom_body,
                  model.geom_offset, "cpu")
    with pytest.raises(ValueError, match="geom bodies"):
        rb.tables(layout.axes, layout.origins, model.dof_lower,
                  model.dof_upper, [0.0, 0.0, -9.81],
                  np.full_like(gb, 13), model.geom_offset, "cpu")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """ops/csrc/rigid_body.cu built for the host with g++."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel's source for the host"
    lib = tmp_path_factory.mktemp("rigid_body") / "librigid_body_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-o", str(lib), str(cuda_build.PACKAGE_DIR / rb.SOURCE)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).rigid_body_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run_host(fn, s, tau, kd, dyn_t, st, params):
    N = s.pos.shape[-1]
    G = st.geom_body.shape[0]
    outs = [torch.full(shape + (N,), float("nan"))
            for shape in rb.output_shapes(G)]
    ptrs, strides, sc = rb.c_args(
        (*s, tau, kd), dyn_t["mass"], dyn_t["com"], dyn_t["inertia"],
        st.rb_table, st.rb_itable, outs,
        rb.scalars(params.dt, params.armature, params.joint_limit_stiffness,
                   params.joint_limit_damping))
    assert fn(ptrs, strides, N, sc) == 0
    return outs


def card_sum(x, dim=None, keepdim=False, **kwargs):
    """torch.sum, adding a dimension of 3, 4 or 6 as the card's reduction
    kernel adds one that is not the fastest-moving (ops/csrc/rigid_body.cu
    `sum3`, `sum4`, `sum6`)."""
    if isinstance(dim, int) and x.shape[dim] in (3, 4, 6):
        t = x.unbind(dim)
        if len(t) == 3:
            r = (t[0] + t[1]) + t[2]
        elif len(t) == 4:
            r = ((t[0] + t[1]) + t[2]) + t[3]
        else:
            r = (((t[0] + t[4]) + (t[1] + t[5])) + t[2]) + t[3]
        return r.unsqueeze(dim) if keepdim else r
    if dim is None:
        return TORCH_SUM(x, **kwargs)
    return TORCH_SUM(x, dim=dim, keepdim=keepdim, **kwargs)


TORCH_SUM = torch.sum


def _libm(name):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]

    def apply(x):
        flat = [fn(float(v)) for v in x.detach().reshape(-1).tolist()]
        return torch.tensor(flat, dtype=torch.float32).reshape(x.shape)
    return apply


@pytest.mark.parametrize("N,seed", [(1, 0), (7, 1), (64, 2)])
def test_kernel_source_on_host_is_plain_in_the_cards_order(
        setup, host_kernel, monkeypatch, N, seed):
    model, layout, params, st = setup
    s, tau, kd, dyn_t = _inputs(model, N, seed)
    s = tt.to_t(tt.from_t(s))
    got = _run_host(host_kernel, s, tau, kd, dyn_t, st, params)
    monkeypatch.setattr(torch, "sum", card_sum)
    monkeypatch.setattr(torch, "sin", _libm("sinf"))
    monkeypatch.setattr(torch, "cos", _libm("cosf"))
    want = _flat(tt.rigid_body_plain(layout, params, dyn_t, s, tau, kd, st))
    monkeypatch.undo()
    for name, a, b in zip(OUTPUTS, got, want):
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("N,seed", [(1, 0), (7, 1), (64, 2), (64, 3)])
def test_kernel_source_on_host_matches_plain(setup, host_kernel, N, seed):
    model, layout, params, st = setup
    s, tau, kd, dyn_t = _inputs(model, N, seed)
    # the state as the substep hands it over: N-major storage seen
    # batch-last, so the kernel reads strided rows
    s = tt.to_t(tt.from_t(s))
    kd = kd.T.contiguous().T
    got = _run_host(host_kernel, s, tau, kd, dyn_t, st, params)
    want = _flat(tt.rigid_body_plain(layout, params, dyn_t, s, tau, kd, st))
    for name, a, b in zip(OUTPUTS, got, want):
        assert not torch.isnan(a).any(), f"{name} not written everywhere"
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)
