"""PyTorch port on the card: the hand-written CUDA kernels (the terrain
patch copy and the substep's rigid-body dynamics) against their plain
versions, the card's env step and CTS, PPO and recurrent-PPO updates
against the CPU path, and checkpoints of runs on the card restored on the
card.

Every test here is marked `gpu` and skips itself without a card. The file
imports torch only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py
"""
import pytest
import torch

from go2_rl_gym_tpu_torch.ops import rigid_body as rb
from go2_rl_gym_tpu_torch.ops import terrain_patches as tp
from go2_rl_gym_tpu_torch.sim import engine as te
from go2_rl_gym_tpu_torch.sim import tengine as tt
from go2_rl_gym_tpu_torch.sim.model import go2_model
from go2_rl_gym_tpu_torch.tools import card_check



def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _channels(C, R, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((3, C, R), generator=g).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("C,R,N", [(40, 256, 5), (96, 256, 42),
                                   (96, 384, 300), (2200, 1408, 4096)])
def test_extract_patches_kernel_bit_exact(C, R, N):
    _card()
    ch = _channels(C, R)
    g = torch.Generator().manual_seed(1)
    ox = torch.randint(-40, R + 40, (N,), generator=g, dtype=torch.int32)
    oy = torch.randint(-40, C + 40, (N,), generator=g, dtype=torch.int32)
    corners = torch.tensor([[0, 0], [R - 32, C - 32], [0, C - 32],
                            [R - 32, 0]], dtype=torch.int32)
    origins = torch.cat([torch.stack([ox, oy], 1), corners]).cuda()
    before = tp.LAUNCHES["extract_patches"]
    got = tp.extract_patches(ch, origins)
    torch.cuda.synchronize()
    assert tp.LAUNCHES["extract_patches"] == before + 1
    assert got.shape == (N + 4, 3, 1024)
    assert torch.equal(got, tp.extract_patches_plain(ch, origins))
    # and the plain version on the CPU (the one the CPU tests hold to JAX)
    assert torch.equal(got.cpu(), tp.extract_patches_plain(ch.cpu(),
                                                           origins.cpu()))


@pytest.mark.gpu
def test_extract_patches_wrapper_refuses_bad_input():
    dev = _card()
    ch = _channels(40, 256)
    org = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        tp.extract_patches(ch, org.long())
    with pytest.raises(TypeError):
        tp.extract_patches(ch.double(), org)
    with pytest.raises(ValueError):
        tp.extract_patches(ch[:, :, ::2], org)
    with pytest.raises(ValueError):
        tp.extract_patches(ch, org.cpu())
    with pytest.raises(ValueError):
        tp.extract_patches(ch[:, :20], org)
    assert tp.extract_patches(ch, org[:0]).shape == (0, 3, 1024)


def _rb_inputs(N, seed, dev):
    """The rigid-body stage's inputs on `dev`: a state stored N-major and
    seen batch-last (as the substep hands it over), joints beyond both
    limits, randomised mass, COM and inertia."""
    model = go2_model()
    layout = te.quad_layout(model)
    params = te.SimParams()
    g = torch.Generator().manual_seed(seed)
    quat = torch.randn((N, 4), generator=g)
    lo = torch.as_tensor(model.dof_lower, dtype=torch.float32)
    hi = torch.as_tensor(model.dof_upper, dtype=torch.float32)
    q = lo + (hi - lo) * (1.6 * torch.rand((N, 12), generator=g) - 0.3)
    state = te.SimState(
        base_pos=torch.randn((N, 3), generator=g),
        base_quat=quat / quat.norm(dim=1, keepdim=True), q=q,
        base_lin_vel=torch.randn((N, 3), generator=g),
        base_ang_vel=2 * torch.randn((N, 3), generator=g),
        qd=5 * torch.randn((N, 12), generator=g))
    s = tt.to_t(te.SimState(*[x.to(dev) for x in state]))
    tau = (10 * torch.randn((12, N), generator=g)).to(dev)
    kd = (0.3 + torch.rand((N, 12), generator=g)).to(dev).T
    f32 = dict(dtype=torch.float32)
    dyn_t = dict(
        mass=torch.as_tensor(model.mass, **f32)[:, None]
        * (0.7 + 0.6 * torch.rand((13, N), generator=g)),
        com=torch.as_tensor(model.com, **f32)[:, :, None]
        + 0.02 * torch.randn((13, 3, N), generator=g),
        inertia=torch.as_tensor(model.inertia, **f32)[:, :, :, None]
        * (0.7 + 0.6 * torch.rand((13, 1, 1, N), generator=g)))
    dyn_t = {k: v.to(dev).contiguous() for k, v in dyn_t.items()}
    st = tt._static(model, layout, dev, params.gravity)
    return layout, params, dyn_t, s, tau, kd, st


def _rb_flat(out):
    return tuple(out[:-1]) + tuple(out.si)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [33, 300, 4096])
def test_rigid_body_kernel_matches_plain(N):
    """Bit for bit from 33 envs up (at 1 env torch.sum reduces the
    contractions' small dimensions as the fastest-moving ones, in another
    order; the benchmark's cells run 2048 to 8192)."""
    dev = _card()
    args = _rb_inputs(N, seed=N, dev=dev)
    before = rb.LAUNCHES["rigid_body"]
    got = _rb_flat(tt.rigid_body(*args))
    torch.cuda.synchronize()
    assert rb.LAUNCHES["rigid_body"] == before + 1
    want = _rb_flat(tt.rigid_body_plain(*args))
    # bit for bit: the kernel rounds and adds as the plain version does on
    # the card (ops/csrc/rigid_body.cu, "Numbers")
    for x, y in zip(got, want):
        assert x.shape == y.shape and bool(torch.isfinite(x).all())
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_rigid_body_wrapper_refuses_bad_input():
    dev = _card()
    layout, params, dyn_t, s, tau, kd, st = _rb_inputs(8, seed=0, dev=dev)
    with pytest.raises(TypeError):
        tt.rigid_body(layout, params, dyn_t, s, tau.double(), kd, st)
    with pytest.raises(ValueError):
        tt.rigid_body(layout, params, dyn_t, s, tau.cpu(), kd, st)
    with pytest.raises(ValueError):
        tt.rigid_body(layout, params, dyn_t, s, tau[:6], kd, st)
    nm = dict(dyn_t, inertia=torch.movedim(
        dyn_t["inertia"].permute(3, 0, 1, 2).contiguous(), 0, -1))
    with pytest.raises(ValueError):
        tt.rigid_body(layout, params, nm, s, tau, kd, st)


@pytest.mark.gpu
def test_env_on_card_matches_cpu():
    """4 rough-terrain steps from one state on both devices (tolerances of
    tests/test_torch_env.py), each launching the patch kernel once and the
    rigid-body kernel once a substep."""
    _card()
    before = tp.LAUNCHES["extract_patches"]
    before_rb = rb.LAUNCHES["rigid_body"]
    card_check.env_card_vs_cpu(steps=4)
    assert tp.LAUNCHES["extract_patches"] == before + 4
    assert rb.LAUNCHES["rigid_body"] == before_rb + 16


@pytest.mark.gpu
def test_update_on_card_matches_cpu():
    """One full-width go2_moe_cts CTS.update (5 x 4 minibatches) from the
    same state on both devices (card_check.update_card_vs_cpu)."""
    _card()
    worst = card_check.update_card_vs_cpu()
    assert max(worst.values()) <= card_check.UPDATE_ATOL


@pytest.mark.gpu
def test_ppo_update_on_card_matches_cpu():
    """One full-width PPO.update of the go2 task on both devices
    (card_check.ppo_update_card_vs_cpu)."""
    _card()
    worst = card_check.ppo_update_card_vs_cpu()
    assert max(worst.values()) <= card_check.UPDATE_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_recurrent_update_on_card_matches_cpu(rnn_type):
    """One full-width RecurrentPPO.update of the go2_lstm task on both
    devices (card_check.recurrent_update_card_vs_cpu)."""
    _card()
    worst = card_check.recurrent_update_card_vs_cpu(rnn_type=rnn_type)
    assert max(worst.values()) <= card_check.UPDATE_ATOL


def _card_runner(num_envs=8, task="go2_moe_cts"):
    from go2_rl_gym_tpu_torch.env.config import Go2Cfg
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env
    from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner
    from go2_rl_gym_tpu_torch.utils import registry
    cfg = Go2Cfg()
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.terrain.curriculum = False
    _, tc = registry.get_cfgs(task)
    tc.runner.num_steps_per_env = 4
    return OnPolicyRunner(Go2Env(cfg, num_steps_per_env=4), tc)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(tmp_path):
    """save after a train iteration on the card, load into a fresh runner
    on the card: every tensor of the train and runner state, and both
    generators' states, come back equal."""
    _card()
    a = _card_runner()
    rs, _ = a.train_step(a.init_runner_state(0, init_at_random_ep_len=True))
    path = str(tmp_path / "model_1.pt")
    a.save(rs, path)
    b = _card_runner()
    rs_b = b.load(b.init_runner_state(5), path)
    for x, y in zip(a.alg.model.state_dict().values(),
                    b.alg.model.state_dict().values()):
        assert torch.equal(x, y)
    for o, p in ((a.alg.opt1, b.alg.opt1), (a.alg.opt2, b.alg.opt2)):
        assert torch.equal(o.count, p.count)
        assert all(torch.equal(u, v) for u, v in zip(o.mu + o.nu,
                                                     p.mu + p.nu))
    assert torch.equal(a.alg.lr, b.alg.lr) and b.alg.lr.is_cuda
    assert torch.equal(rs.gen.get_state(), rs_b.gen.get_state())
    assert torch.equal(rs.env_state.gen.get_state(),
                       rs_b.env_state.gen.get_state())
    assert rs_b.gen.device.type == "cuda" and rs_b.obs.is_cuda
    for x, y in ((rs.obs, rs_b.obs), (rs.history, rs_b.history),
                 (rs.env_state.sim.q, rs_b.env_state.sim.q)):
        assert torch.equal(x, y)
    b.train_step(rs_b)                   # and it trains on


@pytest.mark.gpu
def test_recurrent_checkpoint_round_trip_on_card(tmp_path):
    """go2_lstm: save after a train iteration on the card, load into a fresh
    runner on the card: the weights, the Adam state and the carried memory
    come back equal, on the card."""
    _card()
    a = _card_runner(task="go2_lstm")
    rs, _ = a.train_step(a.init_runner_state(0, init_at_random_ep_len=True))
    path = str(tmp_path / "model_1.pt")
    a.save(rs, path)
    b = _card_runner(task="go2_lstm")
    rs_b = b.load(b.init_runner_state(5), path)
    for x, y in zip(a.alg.model.state_dict().values(),
                    b.alg.model.state_dict().values()):
        assert torch.equal(x, y)
    assert all(torch.equal(u, v) for u, v in zip(a.alg.opt.mu + a.alg.opt.nu,
                                                 b.alg.opt.mu + b.alg.opt.nu))
    for x, y in zip((*rs.memory.a, *rs.memory.c),
                    (*rs_b.memory.a, *rs_b.memory.c)):
        assert y.is_cuda and torch.equal(x, y)
    assert float(rs_b.memory.a.h.abs().max()) > 0
    b.train_step(rs_b)                   # and it trains on
