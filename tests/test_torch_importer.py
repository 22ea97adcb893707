"""PyTorch port, the reference state-dict naming
(go2_rl_gym_tpu_torch/export/importer.py) against
go2_rl_gym_tpu.export.importer, for the six CTS families.

* `export_reference_state_dict` of a port model holding `params_from_jax(
  tree)` equals the JAX package's of `tree`, key for key and exactly; so
  does `import_reference_state_dict` of that dict, and loading it back
  gives the model's parameters bit for bit.
* `import_policy_from_pt` of a reference training checkpoint (a torch.save
  of that dict, critic experts included) and of the port's TorchScript
  export (the inference modules) equals the JAX package's of the same file.
"""
import numpy as np
import pytest
import torch

from go2_rl_gym_tpu.export import importer as jimp
from go2_rl_gym_tpu_torch.agents.networks import make_cts_model as t_make
from go2_rl_gym_tpu_torch.env import config as tconfig
from go2_rl_gym_tpu_torch.export import exporter as texp
from go2_rl_gym_tpu_torch.export import importer as timp
from test_torch_export import (FAMILIES, HIST, NUM_ACT, NUM_OBS, NUM_PRIV,
                               SMALL, assert_trees_equal, cts_pair)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These small CPU problems gain nothing from torch's intra-op threads,
    and the test run's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fresh_model(family):
    return t_make(family, NUM_OBS, NUM_PRIV, NUM_ACT,
                  tconfig.PolicyCfg(**SMALL), HIST, device="cpu")


def assert_same_params(a, b):
    na, nb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(na) == sorted(nb)
    for k in na:
        assert torch.equal(na[k], nb[k]), k


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_state_dict_round_trip(family):
    tree, model = cts_pair(family)
    sd = timp.export_reference_state_dict(model, family)
    want = jimp.export_reference_state_dict(tree, family)
    assert sorted(sd) == sorted(want)
    for k in sd:
        assert sd[k].dtype == np.float32, k
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
    # a JAX-layout tree gives the same dict
    tsd = timp.export_reference_state_dict(tree, family)
    assert all(np.array_equal(tsd[k], sd[k]) for k in sd)

    got = timp.import_reference_state_dict(sd, family)
    assert_trees_equal(got, jimp.import_reference_state_dict(want, family))
    assert_same_params(timp.params_from_jax(got, fresh_model(family)), model)


@pytest.mark.parametrize("family", FAMILIES)
def test_import_policy_from_pt_training_checkpoint(family, tmp_path):
    """A reference training checkpoint ({"model_state_dict": ...}, with the
    reference's `.network` wrappers) dispatches to the state-dict importer,
    the critic experts of ac_moe_cts / dual_moe_cts included."""
    tree, model = cts_pair(family)
    sd = timp.export_reference_state_dict(model, family)
    path = str(tmp_path / "ckpt.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in sd.items()}}, path)
    got = timp.import_policy_from_pt(path, family)
    assert_trees_equal(got, jimp.import_policy_from_pt(path, family))
    assert sorted(got["params"]) == sorted(tree["params"])
    loaded = timp.load_pt_policy(path, fresh_model(family))
    assert_same_params(loaded, model)


@pytest.mark.parametrize("family", ["cts", "moe_cts"])
def test_import_policy_from_pt_port_export(family, tmp_path):
    """The port's TorchScript export carries the inference modules: both
    importers read the same partial tree from it, and loading it leaves the
    teacher and the critic at the model's weights."""
    tree, model = cts_pair(family)
    path = texp.export_model(model, "jit", family, str(tmp_path))
    got = timp.import_policy_from_pt(path, family)
    assert_trees_equal(got, jimp.import_policy_from_pt(path, family))
    assert sorted(got["params"]) == ["actor", "student_encoder"]
    _, other = cts_pair(family, seed=3)
    before = {k: v.clone() for k, v in other.named_parameters()}
    timp.load_pt_policy(path, other)
    for k, v in other.named_parameters():
        src = model if k.startswith(("actor.", "student_encoder.")) else None
        want = dict(src.named_parameters())[k] if src else before[k]
        assert torch.equal(v, want), k
