"""PyTorch port: the graft entry points (go2_rl_gym_tpu_torch/
graft_entry.py, twin of __graft_entry__.py) on the CPU.

* `entry(device="cpu")`'s forward (the go2_moe_cts student path at batch
  256) against `__graft_entry__.entry()`'s jitted forward, on the JAX
  init's weights carried across by importer.params_from_jax and seeded
  inputs, at 1e-5.
* `dryrun_multichip(2, device="cpu")`: the go2_moe_cts train step on two
  gloo ranks of distributed/check.py ends with finite metrics, the same
  value loss on both ranks, the `dryrun_multichip(2) OK` line,
  and no deprecation warning from the ranks (the MoE load balance's
  autograd all-reduce runs in it).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu_torch import graft_entry
from go2_rl_gym_tpu_torch.export.importer import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax():
    import __graft_entry__
    jforward, (jparams, jobs, jhist) = __graft_entry__.entry()
    forward, (model, obs, hist) = graft_entry.entry(device="cpu")
    assert tuple(obs.shape) == tuple(jobs.shape)
    assert tuple(hist.shape) == tuple(jhist.shape)
    params_from_jax(jax.tree.map(np.asarray, jparams), model)
    rng = np.random.default_rng(0)
    o = rng.normal(size=obs.shape).astype(np.float32)
    h = rng.normal(size=hist.shape).astype(np.float32)
    want = np.asarray(jax.jit(jforward)(jparams, jnp.asarray(o),
                                        jnp.asarray(h)))
    got = forward(model, torch.as_tensor(o), torch.as_tensor(h))
    assert got.shape == (graft_entry.BATCH, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the example batch runs too
    assert bool(torch.isfinite(forward(model, obs, hist)).all())


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    results = graft_entry.dryrun_multichip(2, device="cpu", timeout_s=300)
    assert "dryrun_multichip(2) OK — value_loss=" in capsys.readouterr().out
    assert len(results) == 2
    for res in results:
        assert res["finite"]
        for k in ("value_loss", "surrogate_loss", "latent_loss"):
            assert bool(torch.isfinite(res["metrics"][k]).all()), k
        # the counter counts kernel launches; the CPU's plain version none
        # (chip_smoke.py's phase graft sees one per policy step per rank)
        assert res["launches"] == {"extract_patches": 0, "rigid_body": 0}
        assert "deprecat" not in res["log"].lower(), res["log"][-2000:]
    # data-parallel: the parameters' losses agree across the ranks
    assert float(results[0]["metrics"]["value_loss"]) == float(
        results[1]["metrics"]["value_loss"])
