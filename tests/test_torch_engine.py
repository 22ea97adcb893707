"""PyTorch port: the N-major reference engine (go2_rl_gym_tpu_torch/sim/
engine.py's dynamics half) against the JAX package's sim/engine.py, the
port's twins of tests/test_engine.py's physical invariants, and the port's
production engine (sim/tengine.py) against this one.

* Per function, at one env and at N = 8, on seeded numpy inputs: inv3,
  inv6_spd, forward_kinematics, geom_positions, world_dynamics,
  mass_matrix_and_bias, structured_solve and dense_mass_matrix against
  the JAX functions vmapped. Tolerance 1e-5 absolute plus 1e-5 relative:
  fp32 rounding of the same arithmetic in another summation order, on
  entries up to ~50 (the mass matrix, the bias).
* One substep and 4 chained substeps in contact, on the flat terrain and on
  a rough heightfield, at the single-substep tolerances of
  tests/test_torch_physics.py (positions, angles, quaternions 1e-5,
  velocities 1e-4, forces 1e-3 + 1e-4 relative).
* The invariants of tests/test_engine.py at its thresholds.
* Cross-parity: one decimated step of tengine.make_physics_step against 4
  substeps of make_batched_substep at solver_iters=30, at the tolerances of
  tests/test_tengine.py:68-82 (the JAX package's guard that a solver change
  is applied to both engines).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.sim import engine as je
from go2_rl_gym_tpu.sim.model import go2_model as j_go2
from go2_rl_gym_tpu_torch.core import maths as tmaths
from go2_rl_gym_tpu_torch.sim import engine as te
from go2_rl_gym_tpu_torch.sim import tengine as tt
from go2_rl_gym_tpu_torch.sim.model import go2_model as t_go2

DEFAULT_Q = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                      0.1, 1.0, -1.5, -0.1, 1.0, -1.5], np.float32)
KP, KD = 20.0, 0.5
FN_TOL = dict(atol=1e-5, rtol=1e-5)
# a solve of H amplifies the rounding of H's entries by its condition
# number (~1e3 with the armature's 1e-3 on the joint diagonal): 1e-4 on
# solutions up to ~150
SOLVE_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return j_go2(), t_go2()


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def layout(model):
    return te.quad_layout(model)


@pytest.fixture(scope="module")
def heightfield():
    rng = np.random.default_rng(0)
    return (rng.normal(0, 0.02, (256, 256))
            + 0.1 * np.sin(np.arange(256) * 0.2)[:, None]).astype(np.float32)


def _close(j, t, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _state_arrays(seed, n, offset=0.0):
    rng = np.random.default_rng(seed)
    quat = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)) + 0.05 * rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    arrays = dict(
        base_pos=np.array([0.0, 0.0, 0.34]) + offset
        + 0.05 * rng.normal(size=(n, 3)),
        base_quat=quat,
        q=DEFAULT_Q + 0.2 * rng.normal(size=(n, 12)),
        base_lin_vel=0.3 * rng.normal(size=(n, 3)),
        base_ang_vel=0.3 * rng.normal(size=(n, 3)),
        qd=0.5 * rng.normal(size=(n, 12)))
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


def _both(arrays, jtype, ttype):
    return (jtype(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            ttype(**{k: torch.as_tensor(v) for k, v in arrays.items()}))


def _dyn_arrays(model, n, seed=None):
    """Default dynamics per env; with a seed, perturbed masses, COMs and
    inertias, friction in [0.5, 1.25] and restitution in [0, 0.5]."""
    d = dict(mass=np.tile(model.mass, (n, 1)),
             com=np.tile(model.com, (n, 1, 1)),
             inertia=np.tile(model.inertia, (n, 1, 1, 1)),
             friction=np.ones(n), restitution=np.zeros(n))
    if seed is not None:
        rng = np.random.default_rng(seed)
        d["mass"] = d["mass"] * rng.uniform(0.8, 1.2, d["mass"].shape)
        d["com"] = d["com"] + 0.01 * rng.normal(size=d["com"].shape)
        d["inertia"] = d["inertia"] * rng.uniform(0.9, 1.1, (n, 13, 1, 1))
        d["friction"] = rng.uniform(0.5, 1.25, n)
        d["restitution"] = rng.uniform(0.0, 0.5, n)
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _pair(models, n, seed=0, offset=0.0):
    jmodel, tmodel = models
    js, ts = _both(_state_arrays(seed, n, offset), je.SimState, te.SimState)
    jd, td = _both(_dyn_arrays(tmodel, n, seed + 100), je.DynParams,
                   te.DynParams)
    damp = np.random.default_rng(seed + 200).uniform(
        0.3, 0.7, (n, 12)).astype(np.float32)
    return js, ts, jd, td, damp


# ---------------------------------------------------------------------------
# per-function parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 8])
def test_small_inverses_match_jax(n):
    rng = np.random.default_rng(n)
    a3 = rng.normal(size=(n, 4, 3, 3)).astype(np.float32)
    m3 = a3 @ np.swapaxes(a3, -1, -2) + np.eye(3, dtype=np.float32)
    a6 = rng.normal(size=(n, 6, 6)).astype(np.float32)
    m6 = a6 @ np.swapaxes(a6, -1, -2) + np.eye(6, dtype=np.float32)
    _close(je.inv3(jnp.asarray(m3)), te.inv3(torch.as_tensor(m3)), **FN_TOL)
    _close(je.inv6_spd(jnp.asarray(m6)), te.inv6_spd(torch.as_tensor(m6)),
           **FN_TOL)
    # and they are inverses
    np.testing.assert_allclose(te.inv6_spd(torch.as_tensor(m6)).numpy() @ m6,
                               np.broadcast_to(np.eye(6), m6.shape),
                               atol=1e-4)


def test_top_k_matches_jax():
    """Values and indices of jax.lax.top_k, ties to the lower index, on
    rows with many exact ties (the contact selection of both engines)."""
    x = np.random.default_rng(0).integers(0, 5, (64, 78)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 12)
    tv, ti = te.top_k(torch.as_tensor(x), 12)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n", [1, 8])
def test_kinematics_match_jax(models, n):
    jmodel, tmodel = models
    js, ts, _, _, _ = _pair(models, n, seed=3)
    jl, tl = je.quad_layout(jmodel), te.quad_layout(tmodel)
    jfk = jax.vmap(lambda s: je.forward_kinematics(jl, s))(js)
    tfk = te.forward_kinematics(tl, ts)
    for j, t in zip(jfk, tfk):
        assert tuple(t.shape) == tuple(j.shape)
        _close(j, t, **FN_TOL)
    jg = jax.vmap(lambda R, p, w, v: je.geom_positions(jmodel, R, p, w, v))(
        *jfk[:4])
    tg = te.geom_positions(tmodel, *tfk[:4])
    for j, t in zip(jg, tg):
        _close(j, t, **FN_TOL)


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("fn", ["world_dynamics", "mass_matrix_and_bias"])
def test_dynamics_match_jax(models, n, fn):
    """The structured inertia's blocks and inverses, the bias, the dense H
    and a structured solve of seeded right-hand sides."""
    jmodel, tmodel = models
    js, ts, jd, td, damp = _pair(models, n, seed=4)
    jl, tl = je.quad_layout(jmodel), te.quad_layout(tmodel)
    params = je.SimParams()
    jout = jax.vmap(lambda d, s, c: getattr(je, fn)(jl, params, d, s, c))(
        jd, js, jnp.asarray(damp))
    tout = getattr(te, fn)(tl, te.SimParams(), td, ts, torch.as_tensor(damp))
    jsi, tsi = jout[0], tout[0]
    for name in je.StructuredInertia._fields:
        _close(getattr(jsi, name), getattr(tsi, name), **FN_TOL)
    _close(jout[1], tout[1], **FN_TOL)
    _close(jax.vmap(je.dense_mass_matrix)(jsi), te.dense_mass_matrix(tsi),
           **FN_TOL)
    rhs = np.random.default_rng(5).normal(size=(n, 18, 5)).astype(np.float32)
    for r in (rhs, rhs[..., 0]):
        _close(jax.vmap(je.structured_solve)(jsi, jnp.asarray(r)),
               te.structured_solve(tsi, torch.as_tensor(r)), **SOLVE_TOL)


# ---------------------------------------------------------------------------
# substep parity with the JAX package
# ---------------------------------------------------------------------------


def _terrains(kind, hf):
    if kind == "flat":
        return je.flat_terrain(), te.flat_terrain()
    return (je.make_terrain_data(hf, 0.1, 0.0, with_channels=False),
            te.make_terrain_data(hf, 0.1, 0.0, with_channels=False))


@pytest.mark.parametrize("kind", ["flat", "rough", "limits"])
@pytest.mark.parametrize("substeps", [1, 4])
def test_substeps_match_jax(models, heightfield, kind, substeps):
    """From the same states in contact, `substeps` chained substeps of the
    port's batched engine against the JAX package's vmapped one; "limits"
    starts half the joints past their URDF limits (the implicit spring and
    its extra damping)."""
    jmodel, tmodel = models
    jter, tter = _terrains("flat" if kind == "limits" else kind, heightfield)
    offset = np.array([12.0, 12.0, -0.1]) if kind == "rough" else 0.0
    js, ts, jd, td, damp = _pair(models, 8, seed=11, offset=offset)
    if kind == "limits":
        q = np.array(js.q)
        lo, hi = tmodel.dof_lower, tmodel.dof_upper
        q[:, 0::2] = np.where(np.arange(8)[:, None] % 2, lo[0::2] - 0.05,
                              hi[0::2] + 0.05)
        q = q.astype(np.float32)
        js, ts = js._replace(q=jnp.asarray(q)), ts._replace(
            q=torch.as_tensor(q))
    tau = (5.0 * np.random.default_rng(12).normal(size=(substeps, 8, 12))
           ).astype(np.float32)
    jstep = jax.jit(je.make_batched_substep(jmodel, je.SimParams(), jter))
    tstep = te.make_batched_substep(tmodel, te.SimParams(), tter, device=CPU)
    for i in range(substeps):
        js, jo = jstep(jd, js, jnp.asarray(tau[i]), jnp.asarray(damp))
        ts, to = tstep(td, ts, torch.as_tensor(tau[i]), torch.as_tensor(damp))
    for f, atol in (("base_pos", 1e-5), ("base_quat", 1e-5), ("q", 1e-5),
                    ("base_lin_vel", 1e-4), ("base_ang_vel", 1e-4),
                    ("qd", 1e-4)):
        _close(getattr(js, f), getattr(ts, f), atol=atol)
    for f in ("contact_forces", "foot_forces"):
        _close(getattr(jo, f), getattr(to, f), atol=1e-3, rtol=1e-4)
    for f in ("foot_pos", "foot_vel"):
        _close(getattr(jo, f), getattr(to, f), atol=1e-5)
    # in contact (the limits case: past the limits), or it tests nothing
    if kind != "limits":
        assert float(np.abs(np.asarray(jo.foot_forces)).sum()) > 1.0


def test_contact_ties_and_duplicate_bodies(models):
    """At rest on flat ground the feet's gaps tie exactly and the top-K cut
    keeps the lower geom index; a body with several contacts (the base
    pressed into the ground) sums them, as .at[].add does."""
    jmodel, tmodel = models
    n = 2
    arrays = _state_arrays(0, n)
    arrays.update(base_pos=np.array([[0.0, 0.0, 0.30], [0.0, 0.0, 0.02]],
                                    np.float32),
                  base_quat=np.tile(np.float32([0, 0, 0, 1]), (n, 1)),
                  q=np.tile(DEFAULT_Q, (n, 1)),
                  base_lin_vel=np.zeros((n, 3), np.float32),
                  base_ang_vel=np.zeros((n, 3), np.float32),
                  qd=np.zeros((n, 12), np.float32))
    js, ts = _both(arrays, je.SimState, te.SimState)
    jd, td = _both(_dyn_arrays(tmodel, n), je.DynParams, te.DynParams)
    damp = np.full((n, 12), KD, np.float32)
    tau = np.zeros((n, 12), np.float32)
    js, jo = jax.jit(je.make_batched_substep(
        jmodel, je.SimParams(), je.flat_terrain()))(
        jd, js, jnp.asarray(tau), jnp.asarray(damp))
    ts, to = te.make_batched_substep(
        tmodel, te.SimParams(), te.flat_terrain(), device=CPU)(
        td, ts, torch.as_tensor(tau), torch.as_tensor(damp))
    _close(jo.foot_forces, to.foot_forces, atol=1e-3, rtol=1e-4)
    _close(jo.contact_forces, to.contact_forces, atol=1e-3, rtol=1e-4)
    _close(js.qd, ts.qd, atol=1e-4)
    # the sunk env has more than one non-foot contact on one body
    assert float(np.abs(np.asarray(jo.contact_forces[1])).max()) > 1.0


# ---------------------------------------------------------------------------
# physical invariants (twins of tests/test_engine.py, at its thresholds)
# ---------------------------------------------------------------------------


def make_state(z=0.42, q=DEFAULT_Q, xy=(0.0, 0.0), n=1):
    def rep(x):
        return torch.as_tensor(np.asarray(x, np.float32)).expand(
            n, len(x)).clone()
    return te.SimState(base_pos=rep([xy[0], xy[1], z]),
                       base_quat=rep([0.0, 0.0, 0.0, 1.0]), q=rep(q),
                       base_lin_vel=torch.zeros((n, 3)),
                       base_ang_vel=torch.zeros((n, 3)),
                       qd=torch.zeros((n, 12)))


def _dyn(model, n=1):
    return te.DynParams(*[x.expand((n,) + x.shape).clone()
                          for x in te.default_dyn_params(model)])


def _pd_hold(model, params, terrain, state, steps):
    effort = torch.as_tensor(model.dof_effort_limit, dtype=torch.float32)
    step = te.make_batched_substep(model, params, terrain, device=CPU)
    dyn = _dyn(model, state.q.shape[0])
    q0 = torch.as_tensor(DEFAULT_Q)
    kd = torch.full_like(state.q, KD)
    for _ in range(steps):
        tau = torch.clamp(KP * (q0 - state.q) - KD * state.qd, -effort, effort)
        state, out = step(dyn, state, tau, kd)
    return state, out


def test_free_fall(model, layout):
    si, bias, _ = te.mass_matrix_and_bias(layout, te.SimParams(), _dyn(model),
                                          make_state(z=3.0),
                                          torch.zeros((1, 12)))
    du = te.structured_solve(si, -bias)[0].numpy()
    # base linear acceleration in base frame == gravity, joints ~0
    np.testing.assert_allclose(du[3:6], [0.0, 0.0, -9.81], atol=5e-3)
    np.testing.assert_allclose(du[:3], 0.0, atol=5e-3)
    np.testing.assert_allclose(du[6:], 0.0, atol=5e-2)


@pytest.mark.parametrize("fn", ["mass_matrix_and_bias", "world_dynamics"])
def test_mass_matrix_symmetric_pd(model, layout, fn):
    q = DEFAULT_Q + 0.3 * np.random.default_rng(0).normal(size=12)
    si, _, _ = getattr(te, fn)(layout, te.SimParams(), _dyn(model),
                               make_state(z=1.0, q=q), torch.zeros((1, 12)))
    H = te.dense_mass_matrix(si)[0].numpy()
    np.testing.assert_allclose(H, H.T, atol=1e-4)
    eigs = np.linalg.eigvalsh(H)
    assert eigs.min() > 0, f"H not PD: min eig {eigs.min()}"
    # total mass appears in the linear-linear block
    np.testing.assert_allclose(H[3:6, 3:6], 15.019 * np.eye(3), atol=1e-3)


@pytest.mark.parametrize("fn", ["mass_matrix_and_bias", "world_dynamics"])
def test_structured_solve_matches_dense(model, layout, fn):
    si, _, _ = getattr(te, fn)(layout, te.SimParams(), _dyn(model),
                               make_state(z=1.0, q=DEFAULT_Q + 0.1),
                               torch.zeros((1, 12)))
    H = te.dense_mass_matrix(si)[0].numpy().astype(np.float64)
    rhs = np.random.default_rng(1).normal(size=(18, 5))
    x_struct = te.structured_solve(
        si, torch.as_tensor(rhs, dtype=torch.float32)[None])[0].numpy()
    np.testing.assert_allclose(x_struct, np.linalg.solve(H, rhs),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("kind", ["flat", "slope"])
def test_standing(model, kind):
    """flat: dropped from 0.42 m with a PD hold it settles, total Fz ==
    weight, and feet-only stance reports zero per-body contact force.
    slope: dropped on a 15-deg ramp it holds position under friction."""
    params = te.SimParams()
    if kind == "flat":
        s, out = _pd_hold(model, params, te.flat_terrain(), make_state(), 600)
        assert bool(torch.isfinite(s.base_pos).all())
        fz = float(out.foot_forces[0, :, 2].sum()
                   + out.contact_forces[0, :, 2].sum())
        np.testing.assert_allclose(fz, 15.019 * 9.81, rtol=0.02)
        assert float(torch.abs(out.contact_forces).max()) < 1e-3
        assert float(torch.abs(s.qd).max()) < 0.1
        assert 0.2 < float(s.base_pos[0, 2]) < 0.35
        assert float(torch.abs(s.base_quat[0, :3]).max()) < 0.05
        assert bool(torch.all(out.foot_forces[0, :, 2] > 5.0))
        return
    n = 256
    xs = np.arange(n) * 0.1
    hf = np.tile((-np.tan(0.26) * xs)[:, None], (1, n)).astype(np.float32)
    terrain = te.TerrainData(height=torch.as_tensor(hf), horizontal_scale=0.1,
                             border_offset=0.0, is_flat=False)
    z0 = float(te.terrain_height(terrain, torch.tensor([12.8, 12.8])))
    s, out = _pd_hold(model, params, terrain,
                      make_state(z=z0 + 0.42, xy=(12.8, 12.8)), 400)
    assert bool(torch.isfinite(s.base_pos).all())
    assert float(torch.linalg.vector_norm(
        s.base_pos[0, :2] - torch.tensor([12.8, 12.8]))) < 0.5
    assert float(out.foot_forces[0, :, 2].sum()
                 + out.contact_forces[0, :, 2].sum()) > 100.0


def test_energy_conservation_no_contact(model, layout):
    """Zero gravity + no contact + no torque: kinetic energy ~ conserved."""
    params0 = te.SimParams(gravity=0.0, armature=0.0)
    rng = np.random.default_rng(3)
    s = make_state(z=5.0)._replace(
        qd=torch.as_tensor(0.5 * rng.normal(size=(1, 12)), dtype=torch.float32),
        base_ang_vel=torch.tensor([[0.2, -0.1, 0.3]]),
        base_lin_vel=torch.tensor([[0.1, 0.2, 0.0]]))
    dyn = _dyn(model)

    def energy(s):
        si, _, Rb = te.mass_matrix_and_bias(layout, params0, dyn, s,
                                            torch.zeros((1, 12)))
        H = te.dense_mass_matrix(si)[0]
        u = torch.cat([Rb[0].T @ s.base_ang_vel[0],
                       Rb[0].T @ s.base_lin_vel[0], s.qd[0]])
        return float(0.5 * u @ H @ u)

    step = te.make_batched_substep(model, params0, te.flat_terrain(),
                                   device=CPU)
    zeros = torch.zeros((1, 12))
    e0 = energy(s)
    for _ in range(200):
        s, _ = step(dyn, s, zeros, zeros)
    e1 = energy(s)
    assert abs(e1 - e0) / (abs(e0) + 1e-9) < 0.05, (e0, e1)


def test_linear_momentum_free_flight(model, layout):
    """In free flight, COM acceleration == g regardless of joint flailing."""
    params = te.SimParams()
    s = make_state(z=10.0)._replace(qd=torch.full((1, 12), 2.0))
    dyn = _dyn(model)
    masses = torch.as_tensor(model.mass, dtype=torch.float32)
    coms = torch.as_tensor(model.com, dtype=torch.float32)

    def com(s):
        R, p, _, _, _, _ = te.forward_kinematics(layout, s)
        c = p[0] + torch.einsum("bij,bj->bi", R[0], coms)
        return torch.sum(masses[:, None] * c, 0) / masses.sum()

    step = te.make_batched_substep(model, params, te.flat_terrain(),
                                   device=CPU)
    zeros = torch.zeros((1, 12))
    c0 = com(s)
    n = 100
    for _ in range(n):
        s, _ = step(dyn, s, zeros, zeros)
    t = n * params.dt
    np.testing.assert_allclose(float(c0[2] - com(s)[2]), 0.5 * 9.81 * t * t,
                               rtol=0.05)


def test_fk_leg_batched_consistency(model, layout):
    """FK body order/positions: feet below base at default pose, symmetric y."""
    R, p, w, v, _, _ = te.forward_kinematics(layout, make_state(z=0.42))
    p0 = p[0].numpy()
    np.testing.assert_allclose(p0[1][:2], [0.1934, 0.0465], atol=1e-6)
    np.testing.assert_allclose(
        p0[2][:2], [0.1934, 0.0465 + 0.0955 * np.cos(0.1)], atol=1e-5)
    np.testing.assert_allclose(p0[1][0], p0[4][0], atol=1e-6)
    np.testing.assert_allclose(p0[1][1], -p0[4][1], atol=1e-6)
    gpos, _ = te.geom_positions(model, R, p, w, v)
    feet = gpos[0, model.foot_geom_idx].numpy()
    assert np.all(feet[:, 2] < 0.15)
    np.testing.assert_allclose(feet[0, 1], -feet[1, 1], atol=1e-5)


def test_heightfield_min_of_three():
    terrain = te.TerrainData(height=torch.tensor([[0.0, 1.0], [2.0, 3.0]]),
                             horizontal_scale=1.0, border_offset=0.0,
                             is_flat=False)
    assert float(te.terrain_height(terrain, torch.tensor([0.5, 0.5]))) == 0.0


def test_batched_substep_matches_single(model, layout):
    """Four copies of one env step as the env alone does (N = 4 vs N = 1)."""
    params = te.SimParams()
    tau = torch.full((1, 12), 0.5)
    kd = torch.full((1, 12), KD)
    single, _ = te.substep(model, layout, params, _dyn(model),
                           te.flat_terrain(), make_state(), tau, kd)
    N = 4
    batched, _ = te.make_batched_substep(
        model, params, te.flat_terrain(), device=CPU)(
        _dyn(model, N), make_state(n=N), tau.expand(N, 12), kd.expand(N, 12))
    for b in range(N):
        np.testing.assert_allclose(batched.base_pos[b].numpy(),
                                   single.base_pos[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(batched.q[b].numpy(), single.q[0].numpy(),
                                   atol=1e-5)


def test_joint_limits_respected(model):
    """Strong constant torque cannot push joints far past URDF limits."""
    params = te.SimParams()
    s = make_state(z=5.0)
    dyn = _dyn(model)
    step = te.make_batched_substep(model, params, te.flat_terrain(),
                                   device=CPU)
    tau = torch.full((1, 12), 23.0)
    zeros = torch.zeros((1, 12))
    for _ in range(400):
        s, _ = step(dyn, s, tau, zeros)
    hi = torch.as_tensor(model.dof_upper, dtype=torch.float32)
    assert bool(torch.all(s.q[0] < hi + 0.5)), (s.q[0] - hi).numpy()


def test_quaternion_convention_is_xyzw(model, layout):
    """A base yawed by 90 degrees (xyzw) puts the FL hip at +x -> +y."""
    s = make_state()._replace(base_quat=tmaths.quat_from_euler_xyz(
        torch.zeros(1), torch.zeros(1), torch.full((1,), np.pi / 2)))
    _, p, _, _, _, _ = te.forward_kinematics(layout, s)
    np.testing.assert_allclose(p[0, 1, :2].numpy(), [-0.0465, 0.1934],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the production engine against this one
# ---------------------------------------------------------------------------


def _engine_gap(pkg, arrays, kind, hf):
    """One decimated step of `pkg`'s production engine and 4 substeps of
    its N-major engine from the same state (solver_iters=30, the torque law
    of tests/test_tengine.py): both results, as numpy SimStates and
    contact forces."""
    N, DEC = arrays["q"].shape[0], 4
    targets = np.broadcast_to(DEFAULT_Q, (DEC, N, 12)) + np.float32(0.05)
    kp = np.full((N, 12), KP, np.float32)
    kd = np.full((N, 12), KD, np.float32)
    ones, zeros = np.ones((N, 12), np.float32), np.zeros((N, 12), np.float32)
    if pkg == "jax":
        from go2_rl_gym_tpu.sim import tengine as jt
        model = j_go2()
        params = je.SimParams(solver_iters=30)
        terrain = _terrains(kind, hf)[0]
        state = je.SimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        dyn = je.DynParams(*[jnp.asarray(v) for v in
                             _dyn_arrays(model, N).values()])
        s_t, out_t, _, _ = jax.jit(jt.make_physics_step(
            model, params, terrain, DEC))(dyn, state, *map(
                jnp.asarray, (targets, kp, kd, ones, zeros)))
        bsub = jax.jit(je.make_batched_substep(model, params, terrain))
        clip, arr = jnp.clip, jnp.asarray
    else:
        model = t_go2()
        params = te.SimParams(solver_iters=30)
        terrain = _terrains(kind, hf)[1]
        state = te.SimState(**{k: torch.as_tensor(v)
                               for k, v in arrays.items()})
        dyn = te.DynParams(*[torch.as_tensor(v) for v in
                             _dyn_arrays(model, N).values()])
        s_t, out_t, _, _ = tt.make_physics_step(model, params, terrain, DEC)(
            dyn, state, *map(torch.as_tensor, (targets, kp, kd, ones, zeros)))
        bsub = te.make_batched_substep(model, params, terrain, device=CPU)
        clip, arr = torch.clamp, torch.as_tensor
    effort = arr(np.asarray(model.dof_effort_limit, np.float32))
    kd_, kp_ = arr(kd), arr(kp)
    s_r = state
    for i in range(DEC):
        tau = clip(kp_ * (arr(targets[i]) - s_r.q) - kd_ * s_r.qd,
                   -effort, effort)
        s_r, out_r = bsub(dyn, s_r, tau, kd_)

    def np_(tree):
        return type(tree)(*[np.asarray(x) for x in tree])
    return np_(s_t), np_(out_t), np_(s_r), np_(out_r)


@pytest.mark.parametrize("kind", ["flat", "rough"])
def test_physics_step_matches_batched_engine(heightfield, kind):
    """One decimated step of tengine.make_physics_step against 4 substeps
    of make_batched_substep with the same torque law, at the tolerances of
    tests/test_tengine.py:68-82 and from its states (rand_states, PRNGKey
    0). With a deep solver both converge to the same contact solution, so
    tengine's warm start does not matter."""
    from test_tengine import rand_states
    arrays = {k: np.array(v, np.float32) for k, v in
              rand_states(jax.random.PRNGKey(0), 8)._asdict().items()}
    if kind == "rough":   # the direct (channel-less) heightfield path
        arrays["base_pos"] += np.float32([12.0, 12.0, -0.1])
    s_t, out_t, s_r, out_r = _engine_gap("torch", arrays, kind, heightfield)

    def close(a, b, **tol):
        np.testing.assert_allclose(a, b, **tol)
    close(s_t.base_pos, s_r.base_pos, atol=2e-4)
    close(s_t.q, s_r.q, atol=2e-3)
    # qd is the most divergence-amplified quantity (f32, 4 contact-rich
    # substeps); 0.1 rad/s on O(5 rad/s) values
    close(s_t.qd, s_r.qd, atol=0.1)
    close(s_t.base_quat, s_r.base_quat, atol=2e-4)
    close(out_t.contact_forces, out_r.contact_forces, atol=2.0, rtol=0.05)
    close(out_t.foot_pos, out_r.foot_pos, atol=1e-3)
    assert float(np.abs(out_r.foot_forces).sum()) > 1.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["flat", "rough"])
def test_engines_differ_as_jax_engines_do(heightfield, kind, seed):
    """From other states (numpy seeds) the two engines' qd drift apart by
    up to ~0.2 rad/s in the JAX package itself (warm start vs cold start,
    at 30 iterations): the port's two engines differ from each other as
    the JAX package's two do, at the single-substep tolerances."""
    offset = 0.0 if kind == "flat" else np.array([12.0, 12.0, -0.1])
    arrays = _state_arrays(seed, 8, offset)
    j = _engine_gap("jax", arrays, kind, heightfield)
    t = _engine_gap("torch", arrays, kind, heightfield)
    for f, atol in (("base_pos", 1e-5), ("base_quat", 1e-5), ("q", 1e-5),
                    ("base_lin_vel", 1e-4), ("base_ang_vel", 1e-4),
                    ("qd", 1e-4)):
        np.testing.assert_allclose(
            getattr(t[0], f) - getattr(t[2], f),
            getattr(j[0], f) - getattr(j[2], f), atol=atol)
    np.testing.assert_allclose(t[1].contact_forces - t[3].contact_forces,
                               j[1].contact_forces - j[3].contact_forces,
                               atol=1e-2, rtol=1e-3)
