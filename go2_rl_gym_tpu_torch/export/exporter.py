"""Policy export: pickled parameter tree, TorchScript, ONNX and .g2p
(PyTorch port of go2_rl_gym_tpu/export/exporter.py).

Counterpart of reference legged_gym/utils/exporter.py:13-338. The exported
TorchScript artifact matches the reference's deployed-policy interface — a
single-env module with an embedded 5-frame obs-history ring buffer and
``reset()``, consuming (1, 45) observations — so the reference's MuJoCo
sim2sim and real-robot deploy loops (deploy_go2.py:133-196,
deploy_real_go2.py:40-194) run policies trained by the port unchanged.
MoE-family exports return ``action, (weights, latent)``
(exporter.py:118-166 behavior).

The build functions take the JAX package's parameter layout
(``{"params": tree}`` of numpy arrays, flax Dense kernels (in, out)), as the
JAX package's do, so both packages write the same artifacts from the same
weights. `export_model` is the entry for a port model: one copy of its
parameters to the host (`importer.tree_from_named`), then the build
function. The artifacts are CPU modules and files, whatever device the
model trained on.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from go2_rl_gym_tpu_torch.export import native, onnx_native
from go2_rl_gym_tpu_torch.export.importer import tree_from_named


def _np(tree):
    """The tree with every leaf as a numpy array."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def export_policy_params(params, meta: Dict[str, Any], path: str):
    """Native artifact: pickled numpy param tree + metadata (the JAX
    package's layout, so either package reads the other's file)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": _np(params), "meta": meta}, f)


def load_policy_params(path: str):
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return blob["params"], blob["meta"]


# ---------------------------------------------------------------------------
# TorchScript mirror
# ---------------------------------------------------------------------------


def _mlp_from_flax(fparams, activation="elu", final_act=False):
    """flax MLP params {'fc0': {...}, ...} -> torch Sequential."""
    acts = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh}
    keys = sorted(fparams.keys(), key=lambda k: int(k[2:]))
    layers = []
    for i, k in enumerate(keys):
        kern = np.asarray(fparams[k]["kernel"])
        bias = np.asarray(fparams[k]["bias"])
        lin = nn.Linear(kern.shape[0], kern.shape[1])
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(kern.T.copy()))
            lin.bias.copy_(torch.from_numpy(bias.copy()))
        layers.append(lin)
        if i < len(keys) - 1 or final_act:
            layers.append(acts[activation]())
    return nn.Sequential(*layers)


def _expert_head_tensors(fparams):
    w = torch.from_numpy(np.asarray(fparams["head_kernel"]).copy())
    b = torch.from_numpy(np.asarray(fparams["head_bias"]).copy())
    return w, b


def build_torch_policy(params, family: str, num_obs: int = 45,
                       history_length: int = 5,
                       obs_no_goal_mask=None):
    """Build a single-env torch inference module mirroring act_inference of
    the corresponding reference model (actor_critic_*.py act_inference)."""
    p = params["params"]

    class Base(nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer(
                "history", torch.zeros(1, history_length, num_obs))

        @torch.jit.export
        def reset(self):
            self.history.zero_()

        def _update_history(self, obs):
            self.history = torch.cat(
                [self.history[:, 1:], obs.unsqueeze(1)], dim=1)
            return self.history.flatten(1)

    def l2norm(x):
        return x / torch.norm(x, p=2.0, dim=-1, keepdim=True).clamp_min(1e-12)

    if family in ("cts", "mcp_cts", "ac_moe_cts"):
        student = _mlp_from_flax(p["student_encoder"])
    elif family in ("moe_cts", "dual_moe_cts"):
        moe = p["student_encoder"]["moe"]
        backbone = _mlp_from_flax(moe["experts"]["backbone"], final_act=True)
        head_w, head_b = _expert_head_tensors(moe["experts"])
        gating = _mlp_from_flax(moe["gating"])
    elif family == "moe_ng_cts":
        enc = p["student_encoder"]
        backbone = _mlp_from_flax(enc["experts"]["backbone"], final_act=True)
        head_w, head_b = _expert_head_tensors(enc["experts"])
        gating = _mlp_from_flax(enc["gating"])

    if family in ("cts", "moe_cts", "moe_ng_cts"):
        actor = _mlp_from_flax(p["actor"])
    elif family in ("ac_moe_cts", "dual_moe_cts"):
        a_backbone = _mlp_from_flax(p["actor"]["experts"]["backbone"],
                                    final_act=True)
        a_head_w, a_head_b = _expert_head_tensors(p["actor"]["experts"])
        a_gating = _mlp_from_flax(p["actor"]["gating"])
    elif family == "mcp_cts":
        m_backbone = _mlp_from_flax(p["actor"]["experts"]["backbone"],
                                    final_act=True)
        m_head_w, m_head_b = _expert_head_tensors(p["actor"]["experts"])
        m_gating = _mlp_from_flax(p["actor"]["gating"])

    if family == "cts":
        class Policy(Base):
            def __init__(self):
                super().__init__()
                self.student = student
                self.actor = actor

            def forward(self, obs):
                h = self._update_history(obs)
                latent = l2norm(self.student(h))
                return self.actor(torch.cat([latent, obs], dim=1))
        return Policy()

    if family == "moe_cts":
        class Policy(Base):
            def __init__(self):
                super().__init__()
                self.backbone = backbone
                self.gating = gating
                self.actor = actor
                self.register_buffer("head_w", head_w)
                self.register_buffer("head_b", head_b)

            def forward(self, obs):
                h = self._update_history(obs)
                feats = self.backbone(h)
                E = self.head_w.shape[0]
                feats = feats.reshape(1, E, -1)
                expert_out = torch.einsum("beh,eho->beo", feats, self.head_w) + self.head_b
                weights = torch.softmax(self.gating(h), dim=-1)
                latent = (weights.unsqueeze(-1) * expert_out).sum(dim=1)
                latent = l2norm(latent)
                action = self.actor(torch.cat([latent, obs], dim=1))
                return action, (weights, latent)
        return Policy()

    if family == "moe_ng_cts":
        mask_idx = torch.tensor(np.nonzero(np.asarray(obs_no_goal_mask))[0])

        class Policy(Base):
            def __init__(self):
                super().__init__()
                self.backbone = backbone
                self.gating = gating
                self.actor = actor
                self.register_buffer("head_w", head_w)
                self.register_buffer("head_b", head_b)
                self.register_buffer("mask_idx", mask_idx)
                self.hl = history_length
                self.no = num_obs

            def forward(self, obs):
                h = self._update_history(obs)
                hist = h.reshape(1, self.hl, self.no)
                expert_in = hist[:, :, self.mask_idx].flatten(1)
                feats = self.backbone(expert_in)
                E = self.head_w.shape[0]
                feats = feats.reshape(1, E, -1)
                expert_out = torch.einsum("beh,eho->beo", feats, self.head_w) + self.head_b
                weights = torch.softmax(self.gating(h), dim=-1)
                latent = (weights.unsqueeze(-1) * expert_out).sum(dim=1)
                latent = l2norm(latent)
                action = self.actor(torch.cat([latent, obs], dim=1))
                return action, (weights, latent)
        return Policy()

    if family == "mcp_cts":
        mask_idx = torch.tensor(np.nonzero(np.asarray(obs_no_goal_mask))[0])

        class Policy(Base):
            def __init__(self):
                super().__init__()
                self.student = student
                self.backbone = m_backbone
                self.gating = m_gating
                self.register_buffer("head_w", m_head_w)
                self.register_buffer("head_b", m_head_b)
                self.register_buffer("mask_idx", mask_idx)

            def forward(self, obs):
                h = self._update_history(obs)
                latent = l2norm(self.student(h))
                x = torch.cat([latent, obs], dim=1)
                x_ng = torch.cat([latent, obs[:, self.mask_idx]], dim=1)
                weights = torch.sigmoid(self.gating(x))
                feats = self.backbone(x_ng)
                E = self.head_w.shape[0]
                feats = feats.reshape(1, E, -1)
                out = torch.einsum("beh,eho->beo", feats, self.head_w) + self.head_b
                mu, log_std = out.chunk(2, dim=-1)
                log_std = log_std.clamp(-5.0, 2.0)
                var = torch.exp(2 * log_std) + 1e-9
                w = weights.unsqueeze(-1)
                var_total = 1.0 / ((w / var).sum(dim=1) + 1e-9)
                mu_total = var_total * (w * mu / var).sum(dim=1)
                return mu_total, (weights, latent)
        return Policy()

    if family == "ac_moe_cts":
        class Policy(Base):
            def __init__(self):
                super().__init__()
                self.student = student
                self.a_backbone = a_backbone
                self.a_gating = a_gating
                self.register_buffer("a_head_w", a_head_w)
                self.register_buffer("a_head_b", a_head_b)

            def forward(self, obs):
                h = self._update_history(obs)
                latent = l2norm(self.student(h))
                x = torch.cat([latent, obs], dim=1)
                feats = self.a_backbone(x)
                E = self.a_head_w.shape[0]
                feats = feats.reshape(1, E, -1)
                eo = torch.einsum("beh,eho->beo", feats, self.a_head_w) + self.a_head_b
                weights = torch.softmax(self.a_gating(x), dim=-1)
                action = (weights.unsqueeze(-1) * eo).sum(dim=1)
                return action, (weights, latent)
        return Policy()

    if family == "dual_moe_cts":
        class Policy(Base):
            def __init__(self):
                super().__init__()
                self.s_backbone = backbone
                self.s_gating = gating
                self.register_buffer("s_head_w", head_w)
                self.register_buffer("s_head_b", head_b)
                self.a_backbone = a_backbone
                self.a_gating = a_gating
                self.register_buffer("a_head_w", a_head_w)
                self.register_buffer("a_head_b", a_head_b)

            def forward(self, obs):
                h = self._update_history(obs)
                feats = self.s_backbone(h)
                E = self.s_head_w.shape[0]
                feats = feats.reshape(1, E, -1)
                eo = torch.einsum("beh,eho->beo", feats, self.s_head_w) + self.s_head_b
                sw = torch.softmax(self.s_gating(h), dim=-1)
                latent = (sw.unsqueeze(-1) * eo).sum(dim=1)
                latent = l2norm(latent)
                x = torch.cat([latent, obs], dim=1)
                feats = self.a_backbone(x)
                Ea = self.a_head_w.shape[0]
                feats = feats.reshape(1, Ea, -1)
                eo2 = torch.einsum("beh,eho->beo", feats, self.a_head_w) + self.a_head_b
                weights = torch.softmax(self.a_gating(x), dim=-1)
                action = (weights.unsqueeze(-1) * eo2).sum(dim=1)
                return action, (weights, latent)
        return Policy()

    if family == "lstm":
        # recurrent actor export (reference exporter.py forward_lstm:118-124):
        # hidden/cell state buffers carried in the module, reset() zeroes them
        mem = p["memory_a"]["cell"]
        hidden = np.asarray(mem["hi"]["kernel"]).shape[1]
        lstm = nn.LSTM(input_size=np.asarray(mem["ii"]["kernel"]).shape[0],
                       hidden_size=hidden, num_layers=1)
        # flax OptimizedLSTMCell gates: i, f, g, o with separate input (i*)
        # and recurrent (h*) kernels; torch packs (W_ih (4H, in), W_hh (4H, H))
        with torch.no_grad():
            w_ih = np.concatenate([np.asarray(mem[f"i{g}"]["kernel"]).T
                                   for g in "ifgo"], axis=0)
            w_hh = np.concatenate([np.asarray(mem[f"h{g}"]["kernel"]).T
                                   for g in "ifgo"], axis=0)
            b = np.concatenate([np.asarray(mem[f"h{g}"]["bias"])
                                for g in "ifgo"], axis=0)
            lstm.weight_ih_l0.copy_(torch.from_numpy(w_ih.copy()))
            lstm.weight_hh_l0.copy_(torch.from_numpy(w_hh.copy()))
            lstm.bias_ih_l0.copy_(torch.zeros(4 * hidden))
            lstm.bias_hh_l0.copy_(torch.from_numpy(b.copy()))
        actor = _mlp_from_flax(p["actor"])

        class Policy(nn.Module):
            def __init__(self):
                super().__init__()
                self.rnn = lstm
                self.actor = actor
                self.register_buffer("hidden_state", torch.zeros(1, 1, hidden))
                self.register_buffer("cell_state", torch.zeros(1, 1, hidden))

            @torch.jit.export
            def reset(self):
                self.hidden_state.zero_()
                self.cell_state.zero_()

            def forward(self, obs):
                x, (h, c) = self.rnn(obs.unsqueeze(0),
                                     (self.hidden_state, self.cell_state))
                self.hidden_state = h
                self.cell_state = c
                return self.actor(x.squeeze(0))
        return Policy()

    raise ValueError(f"unsupported family {family}")


def export_policy_as_jit(params, family: str, out_dir: str,
                         filename: str = "policy_jit.pt", num_obs: int = 45,
                         history_length: int = 5, obs_no_goal_mask=None):
    """TorchScript export (reference exporter.py:13-24)."""
    os.makedirs(out_dir, exist_ok=True)
    policy = build_torch_policy(params, family, num_obs, history_length,
                                obs_no_goal_mask)
    scripted = torch.jit.script(policy)
    path = os.path.join(out_dir, filename)
    scripted.save(path)
    return path


def export_policy_as_onnx(params, family: str, out_dir: str,
                          filename: str = "policy.onnx", num_obs: int = 45,
                          history_length: int = 5, obs_no_goal_mask=None):
    """ONNX export (reference exporter.py:27-44 + 195-338 interface).

    Uses the in-repo serializer (export/onnx_native.py) — no ``onnx`` wheel
    needed — and emits the reference's stacked-by-term stateless interface
    (input ``obs``: (1, num_obs) for ppo, (1, L*num_obs) otherwise; outputs
    actions[, weights[, latent]] per family — exporter.py:317-338)."""
    return onnx_native.export_policy_as_onnx_native(
        params, family, out_dir, filename, num_obs, history_length,
        obs_no_goal_mask)


def export_policy_as_pkl(params, meta, out_dir: str,
                         filename: str = "policy.pkl"):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    export_policy_params(params, meta, path)
    return path


# ---------------------------------------------------------------------------
# Stacked-history (ONNX-style) input adapter
# ---------------------------------------------------------------------------


def build_torch_policy_stacked(params, family: str, num_obs: int = 45,
                               history_length: int = 5,
                               obs_no_goal_mask=None,
                               term_dims=(3, 3, 3, 12, 12, 12)):
    """Policy consuming a full stacked-BY-TERM obs history in one tensor.

    Counterpart of the reference ONNX exporter's `flatten_obs` interface
    (exporter.py:238-262): evaluation harnesses (RoboGauge-style) feed
    IsaacLab-layout inputs [term0 over all frames | term1 over all frames |
    ...]; this adapter reorders them to stacked-by-frame and runs the
    stateless policy (no internal ring buffer)."""
    inner = build_torch_policy(params, family, num_obs, history_length,
                               obs_no_goal_mask)
    dims = list(term_dims)
    if sum(dims) != num_obs:
        raise ValueError(f"term_dims {term_dims} sum to {sum(dims)}, "
                         f"num_obs is {num_obs}")

    class Stacked(nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = inner
            self.term_dims = dims
            self.hl = history_length
            self.no = num_obs

        def forward(self, x):
            frames = x.shape[1] // self.no
            chunks = torch.split(
                x, [d * frames for d in self.term_dims], dim=1)
            per_term = [c.reshape(-1, frames, d)
                        for c, d in zip(chunks, self.term_dims)]
            history = torch.cat(per_term, dim=2)          # (B, frames, obs)
            # feed frames through the inner ring-buffer policy in order
            self.inner.reset()
            out = self.inner(history[:, 0, :])
            for i in range(1, frames):
                out = self.inner(history[:, i, :])
            return out

    return Stacked()


# ---------------------------------------------------------------------------
# A port model -> an artifact
# ---------------------------------------------------------------------------


def model_no_goal_mask(model: nn.Module) -> Optional[tuple]:
    """The boolean obs mask of a CTS model built with one (moe_ng_cts and
    mcp_cts need it to export), else None."""
    idx = getattr(model, "no_goal_idx", None)
    if idx is None:
        return None
    keep = set(idx.tolist())
    return tuple(i in keep for i in range(model.num_obs))


def export_model(model: nn.Module, kind: str, family: str, out_dir: str,
                 filename: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Write one artifact of a port model (any device): `kind` is "jit"
    (TorchScript), "onnx", "g2p" (the native shim's file) or "pkl" (with
    `meta`); `family` is the build functions' (a CTS family, "lstm", or
    "ppo" for ONNX). The parameters come to the host once, in the JAX
    package's layout; the obs width, history length and no-goal mask are
    the model's. Returns the file's path."""
    params = tree_from_named(model.named_parameters())
    num_obs = getattr(model, "num_obs", 45)
    history_length = getattr(model, "history_length", 5)
    mask = model_no_goal_mask(model)
    if kind == "jit":
        return export_policy_as_jit(params, family, out_dir,
                                    filename or "policy_jit.pt", num_obs,
                                    history_length, mask)
    if kind == "onnx":
        return export_policy_as_onnx(params, family, out_dir,
                                     filename or "policy.onnx", num_obs,
                                     history_length, mask)
    if kind == "g2p":
        return native.export_policy_as_native(
            params, family, out_dir, filename or "policy.g2p", num_obs,
            num_actions=model.std.numel(), history_length=history_length)
    if kind == "pkl":
        return export_policy_as_pkl(params, meta or {}, out_dir,
                                    filename or "policy.pkl")
    raise ValueError(f"unknown artifact kind {kind!r}; "
                     f"kinds: jit, onnx, g2p, pkl")
