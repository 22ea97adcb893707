"""Weights into and out of the port's policy modules
(PyTorch port of go2_rl_gym_tpu/export/importer.py).

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
names, ``memory_a.cell.if.weight`` <-> ``memory_a/cell/if/kernel``). The
reference ``.pt`` naming is mapped both ways for the six CTS families
(``import_reference_state_dict``, ``export_reference_state_dict``).
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


def _mlp_to_sd(params: Dict, prefix: str, sd: Dict[str, np.ndarray],
               stride: int = 2):
    """Inverse of _mlp_from_sd: {fcJ: kernel, bias} ->
    ``<prefix>.<2j>.weight/bias`` (the reference's Sequentials put the
    Linears at even indices, activations between)."""
    keys = sorted(params.keys(), key=lambda k: int(k[2:]))
    for j, k in enumerate(keys):
        sd[f"{prefix}.{j * stride}.weight"] = np.asarray(
            params[k]["kernel"], np.float32).T.copy()
        sd[f"{prefix}.{j * stride}.bias"] = np.asarray(
            params[k]["bias"], np.float32).copy()


def _conv_head_from_sd(sd, key_w, key_b, expert_num: int) -> Dict:
    """Grouped Conv1d (E*O, H, 1) -> head_kernel (E, H, O), head_bias (E, O)."""
    w = np.asarray(sd[key_w], np.float32)
    b = np.asarray(sd[key_b], np.float32)
    EO, H, _ = w.shape
    O = EO // expert_num
    kernel = w[..., 0].reshape(expert_num, O, H).transpose(0, 2, 1)
    return {"head_kernel": np.ascontiguousarray(kernel),
            "head_bias": b.reshape(expert_num, O).copy()}


def _conv_head_to_sd(experts: Dict, key_w, key_b, sd):
    k = np.asarray(experts["head_kernel"], np.float32)   # (E, H, O)
    b = np.asarray(experts["head_bias"], np.float32)     # (E, O)
    E, H, O = k.shape
    sd[key_w] = np.ascontiguousarray(
        k.transpose(0, 2, 1).reshape(E * O, H))[..., None]
    sd[key_b] = b.reshape(E * O).copy()


def _experts_from_sd(sd, backbone_prefix, hidden_key_prefix, conv_prefix,
                     expert_num):
    """The reference's split backbone (experts_backbone + experts_hidden.0 +
    conv) -> Experts params (the backbone MLP with the hidden Linear as its
    last fc)."""
    backbone = _mlp_from_sd(sd, backbone_prefix)
    nfc = len(backbone)
    hid_w = np.asarray(sd[f"{hidden_key_prefix}.0.weight"], np.float32)
    hid_b = np.asarray(sd[f"{hidden_key_prefix}.0.bias"], np.float32)
    backbone[f"fc{nfc}"] = {"kernel": hid_w.T.copy(), "bias": hid_b.copy()}
    out = {"backbone": backbone}
    out.update(_conv_head_from_sd(sd, f"{conv_prefix}.weight",
                                  f"{conv_prefix}.bias", expert_num))
    return out


def _experts_to_sd(experts: Dict, backbone_prefix, hidden_key_prefix,
                   conv_prefix, sd):
    backbone = dict(experts["backbone"])
    keys = sorted(backbone.keys(), key=lambda k: int(k[2:]))
    hidden = backbone.pop(keys[-1])
    _mlp_to_sd(backbone, backbone_prefix, sd)
    sd[f"{hidden_key_prefix}.0.weight"] = np.asarray(
        hidden["kernel"], np.float32).T.copy()
    sd[f"{hidden_key_prefix}.0.bias"] = np.asarray(
        hidden["bias"], np.float32).copy()
    _conv_head_to_sd(experts, f"{conv_prefix}.weight", f"{conv_prefix}.bias",
                     sd)


def _fused_experts_from_sd(sd, prefix, expert_num):
    """utils.Experts (the backbone MLP ends in the E*H layer, the conv is
    named ``<prefix>.experts``) -> Experts params."""
    return {
        "backbone": _mlp_from_sd(sd, f"{prefix}.backbone"),
        **_conv_head_from_sd(sd, f"{prefix}.experts.weight",
                             f"{prefix}.experts.bias", expert_num),
    }


def _fused_experts_to_sd(experts, prefix, sd):
    _mlp_to_sd(experts["backbone"], f"{prefix}.backbone", sd)
    _conv_head_to_sd(experts, f"{prefix}.experts.weight",
                     f"{prefix}.experts.bias", sd)


def _infer_expert_num(sd, gating_prefix) -> int:
    pat = re.compile(re.escape(gating_prefix) + r"\.(\d+)\.weight$")
    idxs = sorted(int(m.group(1)) for k in sd
                  if (m := pat.match(k)) is not None)
    return sd[f"{gating_prefix}.{idxs[-1]}.weight"].shape[0]


def import_reference_state_dict(sd: Dict[str, np.ndarray],
                                family: str) -> Dict:
    """Reference ``model_state_dict`` -> ``{"params": tree}`` for the six
    families' module layouts (reference actor_critic_cts.py /
    actor_critic_moe_cts.py / actor_critic_moe_ng_cts.py /
    actor_critic_mcp_cts.py / actor_critic_ac_moe_cts.py /
    actor_critic_dual_moe_cts.py). Modules missing from `sd` (a deploy
    artifact has no teacher or critic) are absent from the result;
    `params_from_jax` leaves them at the model's weights, which is what the
    JAX package's `complete_params` does with a fresh init."""
    sd = {_norm_name(k): v for k, v in sd.items()}
    p: Dict = {}

    def maybe_mlp(dst, prefix):
        try:
            p[dst] = _mlp_from_sd(sd, prefix)
        except KeyError:
            pass

    maybe_mlp("teacher_encoder", "teacher_encoder")

    # --- student encoder ---
    if family in ("moe_cts", "dual_moe_cts"):
        gating = "student_moe_encoder.moe.gating_network.0"
        E = _infer_expert_num(sd, gating)
        p["student_encoder"] = {"moe": {
            "experts": _fused_experts_from_sd(
                sd, "student_moe_encoder.moe.experts", E),
            "gating": _mlp_from_sd(sd, gating),
        }}
    elif family == "moe_ng_cts":
        E = _infer_expert_num(sd, "student_moe_encoder.gating_network")
        p["student_encoder"] = {
            "experts": _experts_from_sd(
                sd, "student_moe_encoder.experts_backbone",
                "student_moe_encoder.experts_hidden",
                "student_moe_encoder.experts_out", E),
            "gating": _mlp_from_sd(sd, "student_moe_encoder.gating_network"),
        }
    else:
        maybe_mlp("student_encoder", "student_encoder")

    # --- actor ---
    if family == "mcp_cts":
        E = _infer_expert_num(sd, "actor_mcp.gating_network")
        p["actor"] = {
            "experts": _experts_from_sd(sd, "actor_mcp.experts_backbone",
                                        "actor_mcp.experts_hidden",
                                        "actor_mcp.experts_out", E),
            "gating": _mlp_from_sd(sd, "actor_mcp.gating_network"),
        }
    elif family in ("ac_moe_cts", "dual_moe_cts"):
        E = _infer_expert_num(sd, "actor_moe.gating_network.0")
        p["actor"] = {
            "experts": _fused_experts_from_sd(sd, "actor_moe.experts", E),
            "gating": _mlp_from_sd(sd, "actor_moe.gating_network.0"),
        }
    else:
        maybe_mlp("actor", "actor")

    # --- critic ---
    if family in ("ac_moe_cts", "dual_moe_cts"):
        if any(k.startswith("critic_experts.") for k in sd):
            E = p["actor"]["gating"][sorted(
                p["actor"]["gating"])[-1]]["kernel"].shape[1]
            p["critic"] = _fused_experts_from_sd(sd, "critic_experts", E)
    else:
        maybe_mlp("critic", "critic")

    if "std" in sd and family != "mcp_cts":
        p["std"] = np.asarray(sd["std"], np.float32).copy()
    return {"params": p}


def export_reference_state_dict(params, family: str) -> Dict[str, np.ndarray]:
    """A model's parameters -> reference ``model_state_dict`` naming
    (loadable by the reference's ActorCritic*.load_state_dict for matching
    configs). `params` is a port model (read through `tree_from_named`, one
    copy to the host) or a JAX-layout tree, ``{"params": ...}`` or bare."""
    if isinstance(params, nn.Module):
        params = tree_from_named(params.named_parameters())
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}

    if "teacher_encoder" in p:
        _mlp_to_sd(p["teacher_encoder"], "teacher_encoder", sd)

    if "student_encoder" in p:
        se = p["student_encoder"]
        if family in ("moe_cts", "dual_moe_cts"):
            _fused_experts_to_sd(se["moe"]["experts"],
                                 "student_moe_encoder.moe.experts", sd)
            _mlp_to_sd(se["moe"]["gating"],
                       "student_moe_encoder.moe.gating_network.0.network", sd)
        elif family == "moe_ng_cts":
            _experts_to_sd(se["experts"],
                           "student_moe_encoder.experts_backbone",
                           "student_moe_encoder.experts_hidden",
                           "student_moe_encoder.experts_out", sd)
            _mlp_to_sd(se["gating"], "student_moe_encoder.gating_network", sd)
        else:
            _mlp_to_sd(se, "student_encoder", sd)

    if "actor" in p:
        a = p["actor"]
        if family == "mcp_cts":
            _experts_to_sd(a["experts"], "actor_mcp.experts_backbone",
                           "actor_mcp.experts_hidden", "actor_mcp.experts_out",
                           sd)
            _mlp_to_sd(a["gating"], "actor_mcp.gating_network", sd)
        elif family in ("ac_moe_cts", "dual_moe_cts"):
            _fused_experts_to_sd(a["experts"], "actor_moe.experts", sd)
            _mlp_to_sd(a["gating"], "actor_moe.gating_network.0.network", sd)
        else:
            _mlp_to_sd(a, "actor", sd)

    if "critic" in p:
        c = p["critic"]
        if family in ("ac_moe_cts", "dual_moe_cts"):
            _fused_experts_to_sd(c, "critic_experts", sd)
        else:
            _mlp_to_sd(c, "critic", sd)

    if "std" in p:
        sd["std"] = np.asarray(p["std"], np.float32).copy()
    return sd


def _import_deploy_tensors(sd: Dict[str, np.ndarray], family: str) -> Dict:
    """TorchScript deploy artifact (the reference exporter's naming, or the
    exporters' of either package: backbone/gating Sequentials +
    head_w/head_b) -> partial tree (student encoder + actor)."""
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
    """Any reference / JAX-package / port ``.pt`` -> ``{"params": tree}``:
    a training checkpoint's full tree, or a deploy artifact's inference
    modules (student encoder + actor)."""
    sd = tensors_from_pt(path)
    if any(k.startswith(("teacher_encoder.", "critic.", "critic_experts."))
           for k in sd):
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
