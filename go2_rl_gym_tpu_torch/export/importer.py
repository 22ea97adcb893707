"""Weights into the port's policy modules
(PyTorch port of the import side of go2_rl_gym_tpu/export/importer.py).

Two sources:

* the JAX package's ``{"params": ...}`` tree, as nested dicts of numpy
  arrays (``params_from_jax``). Flax kernels are (in, out); torch Linear
  weights are (out, in).
* a reference ``.pt`` file (``load_pt_policy``): a TorchScript deploy
  artifact (student encoder + actor; e.g. the committed
  doc/evidence/go2_moe_cts_r5_75k.pt) or a training checkpoint's
  ``model_state_dict``. Both are first mapped to the same tree layout, by
  the same rules as the JAX package, then loaded with ``params_from_jax``.
  Modules absent from the file (a deploy artifact has no teacher or critic)
  keep their current weights.

``params_from_jax`` and its inverse ``tree_from_named`` work by parameter
name: they cover all six CTS families, ``ActorCritic`` and
``ActorCriticRecurrent`` (LSTM and GRU, whose gate modules carry flax's
names, ``memory_a.cell.if.weight`` <-> ``memory_a/cell/if/kernel``); the
reference ``.pt`` naming is mapped for ``moe_cts`` and ``cts``.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from torch import nn

from go2_rl_gym_tpu_torch.agents.networks import CTSFamily

# ---------------------------------------------------------------------------
# torch -> numpy tensor collection
# ---------------------------------------------------------------------------


def tensors_from_pt(path: str) -> Dict[str, np.ndarray]:
    """Load a reference ``.pt`` into a flat {name: ndarray} dict.

    TorchScript artifacts yield their named parameters and buffers (without
    the embedded history ring buffer); torch.save dicts yield
    model_state_dict (training checkpoints) or the dict itself."""
    try:
        mod = torch.jit.load(path, map_location="cpu")
    except RuntimeError:
        mod = None
    if mod is not None:
        out = {n: p.detach().cpu().numpy() for n, p in mod.named_parameters()}
        out.update({n: b.detach().cpu().numpy()
                    for n, b in mod.named_buffers() if n != "history"})
        return out
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return {n: t.detach().cpu().numpy() for n, t in blob.items()
            if hasattr(t, "detach")}


# ---------------------------------------------------------------------------
# state-dict naming -> JAX-package tree layout
# ---------------------------------------------------------------------------


def _norm_name(name: str) -> str:
    """Collapse the reference utils.MLP's ``.network`` wrapper."""
    return name.replace(".network.", ".")


def _mlp_from_sd(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    """Collect ``<prefix>.<i>.weight/bias`` Linears -> {fcJ: kernel, bias}."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.weight$")
    idxs = sorted(int(m.group(1)) for k in sd
                  if (m := pat.match(k)) is not None)
    if not idxs:
        raise KeyError(f"no Linear layers under '{prefix}'")
    out = {}
    for j, i in enumerate(idxs):
        w = np.asarray(sd[f"{prefix}.{i}.weight"], np.float32)
        b = np.asarray(sd[f"{prefix}.{i}.bias"], np.float32)
        out[f"fc{j}"] = {"kernel": w.T.copy(), "bias": b.copy()}
    return out


def _conv_head_from_sd(sd, key_w, key_b, expert_num: int) -> Dict:
    """Grouped Conv1d (E*O, H, 1) -> head_kernel (E, H, O), head_bias (E, O)."""
    w = np.asarray(sd[key_w], np.float32)
    b = np.asarray(sd[key_b], np.float32)
    EO, H, _ = w.shape
    O = EO // expert_num
    kernel = w[..., 0].reshape(expert_num, O, H).transpose(0, 2, 1)
    return {"head_kernel": np.ascontiguousarray(kernel),
            "head_bias": b.reshape(expert_num, O).copy()}


def _infer_expert_num(sd, gating_prefix) -> int:
    pat = re.compile(re.escape(gating_prefix) + r"\.(\d+)\.weight$")
    idxs = sorted(int(m.group(1)) for k in sd
                  if (m := pat.match(k)) is not None)
    return sd[f"{gating_prefix}.{idxs[-1]}.weight"].shape[0]


def import_reference_state_dict(sd: Dict[str, np.ndarray],
                                family: str) -> Dict:
    """Reference ``model_state_dict`` -> ``{"params": tree}`` for the
    families `moe_cts` and `cts` (reference actor_critic_moe_cts.py /
    actor_critic_cts.py). Missing modules are absent from the result."""
    if family not in ("moe_cts", "cts"):
        raise ValueError(f"family {family!r} is not ported")
    sd = {_norm_name(k): v for k, v in sd.items()}
    p: Dict = {}

    def maybe_mlp(dst, prefix):
        try:
            p[dst] = _mlp_from_sd(sd, prefix)
        except KeyError:
            pass

    maybe_mlp("teacher_encoder", "teacher_encoder")
    if family == "moe_cts":
        gating = "student_moe_encoder.moe.gating_network.0"
        E = _infer_expert_num(sd, gating)
        experts = {"backbone": _mlp_from_sd(
            sd, "student_moe_encoder.moe.experts.backbone")}
        experts.update(_conv_head_from_sd(
            sd, "student_moe_encoder.moe.experts.experts.weight",
            "student_moe_encoder.moe.experts.experts.bias", E))
        p["student_encoder"] = {"moe": {"experts": experts,
                                        "gating": _mlp_from_sd(sd, gating)}}
    else:
        maybe_mlp("student_encoder", "student_encoder")
    maybe_mlp("actor", "actor")
    maybe_mlp("critic", "critic")
    if "std" in sd:
        p["std"] = np.asarray(sd["std"], np.float32).copy()
    return {"params": p}


def _import_deploy_tensors(sd: Dict[str, np.ndarray], family: str) -> Dict:
    """TorchScript deploy artifact (the reference exporter's naming, or the
    JAX package's exporter: backbone/gating Sequentials + head_w/head_b)
    -> partial tree (student encoder + actor)."""
    sd = {_norm_name(k): v for k, v in sd.items()}
    if any(k.startswith("student_moe_encoder.") for k in sd):
        return import_reference_state_dict(sd, family)
    p: Dict = {}
    for prefix in ("student_encoder", "student"):
        try:
            p["student_encoder"] = _mlp_from_sd(sd, prefix)
            break
        except KeyError:
            continue
    if any(k.startswith(("backbone.", "gating.")) for k in sd):
        experts = {"backbone": _mlp_from_sd(sd, "backbone"),
                   "head_kernel": np.asarray(sd["head_w"], np.float32).copy(),
                   "head_bias": np.asarray(sd["head_b"], np.float32).copy()}
        p["student_encoder"] = {"moe": {"experts": experts,
                                        "gating": _mlp_from_sd(sd, "gating")}}
    try:
        p["actor"] = _mlp_from_sd(sd, "actor")
    except KeyError:
        pass
    return {"params": p}


def import_policy_from_pt(path: str, family: str = "moe_cts") -> Dict:
    """Any reference / JAX-package ``.pt`` -> ``{"params": tree}``."""
    sd = tensors_from_pt(path)
    if any(k.startswith(("teacher_encoder.", "critic.")) for k in sd):
        return import_reference_state_dict(sd, family)
    return _import_deploy_tensors(sd, family)


# ---------------------------------------------------------------------------
# tree -> torch modules
# ---------------------------------------------------------------------------


def _copy(dst: torch.Tensor, src):
    src = torch.as_tensor(np.asarray(src, np.float32))
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"shape mismatch: {tuple(dst.shape)} vs "
                         f"{tuple(src.shape)}")
    dst.copy_(src.to(dst.device))


def _tree_path(name: str):
    """A parameter's name in the port -> its path in the JAX tree and
    whether it is a Linear weight (torch (out, in), flax kernel (in, out)).
    The port's module names are the JAX package's, so only the leaf of a
    Linear changes name."""
    parts = tuple(name.split("."))
    if parts[-1] == "weight":
        return parts[:-1] + ("kernel",), True
    return parts, False


def _flatten(tree: Dict, prefix=()) -> Dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def tree_from_named(named) -> Dict:
    """``{"params": tree}`` of numpy arrays in the JAX package's layout from
    (name, tensor) pairs named as the model's parameters: the parameters
    themselves (``model.named_parameters()``), or an optimizer moment zipped
    with its group's names. The inverse of ``params_from_jax``."""
    tree: Dict = {}
    for name, t in named:
        path, transpose = _tree_path(name)
        a = t.detach().cpu().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.T.copy() if transpose else a.copy()
    return {"params": tree}


def tensors_from_tree(names, tree: Dict, device=None):
    """The arrays of a JAX-layout tree (``{"params": ...}`` or bare) as
    tensors, one per name in `names` (port parameter names): a JAX
    CTSTrainState's ``params1`` / ``params2`` or an Adam moment of either,
    lined up with ``cts.split_params``'s groups; a PPOTrainState's
    ``params`` or moment, lined up with ``model.named_parameters()``."""
    flat = _flatten(tree["params"] if "params" in tree else tree)
    out = []
    for name in names:
        path, transpose = _tree_path(name)
        a = np.asarray(flat[path], np.float32)
        out.append(torch.as_tensor(np.ascontiguousarray(a.T if transpose
                                                        else a),
                                   device=device))
    return out


@torch.no_grad()
def params_from_jax(tree: Dict, model: nn.Module) -> nn.Module:
    """Load the JAX package's ``{"params": tree}`` (nested dicts of numpy
    arrays) into `model`: any of the six CTS families, ``ActorCritic`` or
    ``ActorCriticRecurrent``. A top-level module absent from the tree is
    left as it is; a module present with other entries or other shapes
    raises."""
    p = tree["params"] if "params" in tree else tree
    flat = _flatten(p)
    for name, param in model.named_parameters():
        path, transpose = _tree_path(name)
        if path[0] not in p:
            continue
        if path not in flat:
            raise ValueError(f"{'/'.join(path)} is missing from the tree")
        src = np.asarray(flat.pop(path))
        _copy(param, src.T if transpose else src)
    if flat:
        raise ValueError(f"the model has no parameter for "
                         f"{sorted('/'.join(k) for k in flat)}")
    return model


def load_pt_policy(path: str, model: CTSFamily) -> CTSFamily:
    """Load a ``.pt`` policy file into `model` (see the module docstring)."""
    return params_from_jax(import_policy_from_pt(path, model.family), model)
