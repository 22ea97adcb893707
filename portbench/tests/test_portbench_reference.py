"""The frozen plain reference against the port: one train iteration from
the same seed at a tiny terrain and env count, on the CPU, where the port
runs its plain patch extraction too, so both compute alike: the same
metrics and the same parameters after the update, exactly."""
import pytest
import torch

from conftest import TINY
from portbench import spec


@pytest.mark.parametrize("config", sorted(TINY))
def test_one_iteration_equals_the_port(tiny_root, config):
    from go2_rl_gym_tpu_torch.env.go2_env import Go2Env as PortEnv
    from go2_rl_gym_tpu_torch.train.runner import OnPolicyRunner as Port
    from go2_rl_gym_tpu_torch.utils import registry as port_registry

    from portbench.reference.env.go2_env import Go2Env as RefEnv
    from portbench.reference.train.runner import OnPolicyRunner as Ref
    from portbench.reference.utils import registry as ref_registry

    cell = spec.load_cell(tiny_root, "tiny." + config)
    out = []
    for Env, Runner, registry in ((PortEnv, Port, port_registry),
                                  (RefEnv, Ref, ref_registry)):
        env_cfg, train_cfg = spec.build_cfgs(registry, cell)
        env = Env(env_cfg, num_steps_per_env=4, terrain_seed=99,
                  device="cpu")
        runner = Runner(env, train_cfg, device="cpu")
        rs = runner.init_runner_state(99, init_at_random_ep_len=True)
        rs, m = runner.train_step(rs)
        out.append(({k: v.clone() for k, v in m.items()},
                    {k: p.detach().clone()
                     for k, p in runner.alg.model.named_parameters()},
                    rs.obs.clone()))
    (m_port, p_port, o_port), (m_ref, p_ref, o_ref) = out
    assert set(m_port) == set(m_ref)
    for k in m_port:
        assert torch.equal(m_port[k], m_ref[k]), k
    assert set(p_port) == set(p_ref)
    for k in p_port:
        assert torch.equal(p_port[k], p_ref[k]), k
    assert torch.equal(o_port, o_ref)


def test_reference_reads_its_own_patches():
    """The reference cuts patches with plain indexing on every device."""
    from portbench.reference.ops import terrain_patches as ref_tp
    ch = torch.arange(3 * 40 * 256, dtype=torch.float32).reshape(3, 40, 256)
    origins = torch.tensor([[0, 0], [200, 5], [-3, 50]], dtype=torch.int32)
    got = ref_tp.extract_patches(ch, origins)
    assert got.shape == (3, 3, 1024)
    assert torch.equal(got[1, 0].reshape(32, 32), ch[0, 5:37, 200:232])
