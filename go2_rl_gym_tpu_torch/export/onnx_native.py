"""Native ONNX export — no ``onnx``/``torch.onnx`` dependency (copy of
go2_rl_gym_tpu/export/onnx_native.py; numpy only).

The environment has no ``onnx`` wheel, so this module serializes the ONNX
protobuf wire format directly (the schema subset of onnx.proto3 needed for
feed-forward policy graphs) and provides a small numpy interpreter able to
load + execute the generated files for numerical verification. The exported
artifact is a standard ONNX file (ir_version 7 / default opset 11) loadable
by onnxruntime or Netron elsewhere.

Interface parity with the reference ONNX exporter
(reference legged_gym/utils/exporter.py:195-338): the graph is stateless and
consumes the full obs history stacked BY TERM (IsaacLab layout,
``flatten_obs`` term dims [3,3,3,12,12,12]) in one ``(1, L*45)`` tensor; the
stack-by-term -> stack-by-frame reorder is baked into the graph as a constant
Gather permutation. Outputs are ``actions`` (+ ``weights``/``latent`` for the
MoE/MCP families), matching exporter.py:264-338.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Minimal protobuf wire-format writer/reader (the subset onnx.proto3 uses)
# ---------------------------------------------------------------------------

_WT_VARINT = 0
_WT_64 = 1
_WT_LEN = 2
_WT_32 = 5


def _varint(v: int) -> bytes:
    out = b""
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _key(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _f_int(field: int, v: int) -> bytes:
    return _key(field, _WT_VARINT) + _varint(int(v))


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, _WT_LEN) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode())


def _f_float(field: int, v: float) -> bytes:
    return _key(field, _WT_32) + struct.pack("<f", float(v))


def _read_varint(buf: bytes, i: int):
    v = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _parse(buf: bytes):
    """Parse one protobuf message into {field: [raw values]}."""
    i = 0
    out: Dict[int, list] = {}
    while i < len(buf):
        k, i = _read_varint(buf, i)
        field, wt = k >> 3, k & 7
        if wt == _WT_VARINT:
            v, i = _read_varint(buf, i)
        elif wt == _WT_LEN:
            n, i = _read_varint(buf, i)
            v = buf[i:i + n]
            i += n
        elif wt == _WT_32:
            v = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wt == _WT_64:
            v = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out.setdefault(field, []).append(v)
    return out


# ---------------------------------------------------------------------------
# ONNX messages (field numbers from onnx.proto3)
# ---------------------------------------------------------------------------

FLOAT = 1
INT64 = 7

ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_INTS = 7


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.int64:
        dtype = INT64
    else:
        arr = arr.astype(np.float32)
        dtype = FLOAT
    msg = b"".join(_f_int(1, d) for d in arr.shape)
    msg += _f_int(2, dtype)
    msg += _f_str(8, name)
    msg += _f_bytes(9, arr.tobytes())          # raw_data
    return msg


def _attr(name: str, value) -> bytes:
    msg = _f_str(1, name)
    if isinstance(value, float):
        msg += _f_float(2, value) + _f_int(20, ATTR_FLOAT)
    elif isinstance(value, int):
        msg += _f_int(3, value) + _f_int(20, ATTR_INT)
    elif isinstance(value, (list, tuple)):
        msg += b"".join(_f_int(8, v) for v in value) + _f_int(20, ATTR_INTS)
    else:
        raise TypeError(type(value))
    return msg


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          **attrs) -> bytes:
    msg = b"".join(_f_str(1, s) for s in inputs)
    msg += b"".join(_f_str(2, s) for s in outputs)
    msg += _f_str(4, op)
    msg += b"".join(_f_bytes(5, _attr(k, v)) for k, v in attrs.items())
    return msg


def _value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(_f_bytes(1, _f_int(1, d)) for d in shape)
    tensor_type = _f_int(1, FLOAT) + _f_bytes(2, dims)
    type_proto = _f_bytes(1, tensor_type)
    return _f_str(1, name) + _f_bytes(2, type_proto)


class OnnxGraph:
    """Append-only graph assembly producing a serialized ModelProto."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self._n = 0

    def fresh(self, hint: str = "t") -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def add_input(self, name: str, shape):
        self.inputs.append(_value_info(name, shape))

    def add_output(self, name: str, shape):
        self.outputs.append(_value_info(name, shape))

    def const(self, arr: np.ndarray, hint: str = "c") -> str:
        name = self.fresh(hint)
        self.initializers.append(_tensor(name, np.asarray(arr)))
        return name

    def op(self, op_type: str, inputs, n_out: int = 1, hint: Optional[str] = None,
           **attrs):
        outs = [self.fresh(hint or op_type.lower()) for _ in range(n_out)]
        self.nodes.append(_node(op_type, inputs, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    def rename(self, src: str, dst: str):
        """Identity node binding an internal tensor to a public output name."""
        self.nodes.append(_node("Identity", [src], [dst]))

    # -- composite helpers --------------------------------------------------

    def gemm(self, x: str, kernel: np.ndarray, bias: np.ndarray,
             hint="gemm") -> str:
        """y = x @ kernel + bias with kernel (in, out) (flax layout)."""
        w = self.const(np.asarray(kernel, np.float32).T, "W")   # (out, in)
        b = self.const(np.asarray(bias, np.float32), "B")
        return self.op("Gemm", [x, w, b], hint=hint, transB=1)

    def mlp(self, x: str, fparams, activation="elu", final_act=False) -> str:
        keys = sorted(fparams.keys(), key=lambda k: int(k[2:]))
        for i, k in enumerate(keys):
            x = self.gemm(x, np.asarray(fparams[k]["kernel"]),
                          np.asarray(fparams[k]["bias"]), hint=f"fc{i}")
            if i < len(keys) - 1 or final_act:
                x = self.op({"elu": "Elu", "relu": "Relu",
                             "tanh": "Tanh"}[activation], [x])
        return x

    def l2norm(self, x: str) -> str:
        sq = self.op("Mul", [x, x])
        ssum = self.op("ReduceSum", [sq], axes=[1], keepdims=1)
        nrm = self.op("Sqrt", [ssum])
        nrm = self.op("Max", [nrm, self.const(np.asarray([1e-12], np.float32))])
        return self.op("Div", [x, nrm], hint="l2norm")

    def gather_cols(self, x: str, idx: np.ndarray, hint="gather") -> str:
        ind = self.const(np.asarray(idx, np.int64), "idx")
        return self.op("Gather", [x, ind], hint=hint, axis=1)

    def moe_latent(self, hist: str, expert_in: str, enc_params,
                   normalize=True):
        """StudentMoEEncoder forward: returns (latent, weights)."""
        feats = self.mlp(expert_in, enc_params["experts"]["backbone"],
                         final_act=True)
        head_w = np.asarray(enc_params["experts"]["head_kernel"])  # (E,H,O)
        head_b = np.asarray(enc_params["experts"]["head_bias"])    # (E,O)
        E, H, _ = head_w.shape
        logits = self.mlp(hist, enc_params["gating"])
        weights = self.op("Softmax", [logits], hint="weights", axis=1)
        acc = None
        for e in range(E):
            fe = self.gather_cols(feats, np.arange(e * H, (e + 1) * H),
                                  hint=f"feat{e}")
            oe = self.gemm(fe, head_w[e], head_b[e], hint=f"expert{e}")
            we = self.gather_cols(weights, np.asarray([e]), hint=f"w{e}")
            term = self.op("Mul", [oe, we])
            acc = term if acc is None else self.op("Add", [acc, term])
        if normalize:
            acc = self.l2norm(acc)
        return acc, weights

    def serialize(self) -> bytes:
        g = b"".join(_f_bytes(1, n) for n in self.nodes)
        g += _f_str(2, self.name)
        g += b"".join(_f_bytes(5, t) for t in self.initializers)
        g += b"".join(_f_bytes(11, v) for v in self.inputs)
        g += b"".join(_f_bytes(12, v) for v in self.outputs)
        opset = _f_str(1, "") + _f_int(2, 11)
        model = _f_int(1, 7)                     # ir_version 7
        # producer_name: the project's, as the JAX package writes it, so
        # that both packages' files are byte-identical
        model += _f_str(2, "go2_rl_gym_tpu")
        model += _f_str(3, "0.4")
        model += _f_bytes(7, g)
        model += _f_bytes(8, opset)
        return model


# ---------------------------------------------------------------------------
# Stack-by-term -> stack-by-frame permutation (reference exporter.py:238-262)
# ---------------------------------------------------------------------------


def flatten_obs_permutation(history_length: int,
                            term_dims=(3, 3, 3, 12, 12, 12)) -> np.ndarray:
    """perm[j] = index into the stacked-by-term input for element j of the
    stacked-by-frame history."""
    obs_dim = sum(term_dims)
    starts = np.cumsum([0] + list(term_dims))[:-1] * history_length
    perm = np.empty(history_length * obs_dim, np.int64)
    j = 0
    for f in range(history_length):
        for t, d in enumerate(term_dims):
            base = starts[t] + f * d
            perm[j:j + d] = np.arange(base, base + d)
            j += d
    return perm


# ---------------------------------------------------------------------------
# Policy graphs (one per family; exporter.py:264-338 parity)
# ---------------------------------------------------------------------------


def build_policy_onnx(params, family: str, num_obs: int = 45,
                      history_length: int = 5,
                      obs_no_goal_mask=None,
                      term_dims=(3, 3, 3, 12, 12, 12)) -> bytes:
    """Serialize the deploy-time forward of ``family`` to ONNX bytes.

    Interface matches the reference exporter (exporter.py:195-338, ADVICE
    r4): input is named ``obs`` — (1, num_obs) for ppo (forward_ppo consumes
    the current observation only, input_dim = actor in_features), else
    (1, history_length*num_obs) stacked by term. Outputs: ``actions``
    (1, 12); moe families add ``weights`` (1, E) and ``latent`` (1, 32)
    (forward_moe_no_goal_cts returns all three); mcp adds ``weights`` only
    (forward_mcp_cts returns actions+weights); cts/ppo emit actions only.
    """
    if sum(term_dims) != num_obs:
        raise ValueError(
            f"term_dims {term_dims} sum to {sum(term_dims)} != num_obs "
            f"{num_obs}; pass term_dims matching the obs layout "
            "(reference exporter.py:239 hardcodes [3,3,3,A,A,A])")
    p = params["params"]
    g = OnnxGraph(f"go2_{family}")
    L = 1 if family == "ppo" else history_length
    in_dim = L * num_obs
    g.add_input("obs", (1, in_dim))

    perm = flatten_obs_permutation(L, term_dims)
    hist = g.gather_cols("obs", perm, hint="hist")   # by-frame
    obs = g.gather_cols(hist, np.arange((L - 1) * num_obs, L * num_obs),
                        hint="obs_last")

    weights = latent = None
    E = None

    if family == "ppo":
        actions = g.mlp(obs, p["actor"])
    elif family == "cts":
        latent = g.l2norm(g.mlp(hist, p["student_encoder"]))
        x = g.op("Concat", [latent, obs], axis=1)
        actions = g.mlp(x, p["actor"])
    elif family == "moe_cts":
        latent, weights = g.moe_latent(hist, hist, p["student_encoder"]["moe"])
        x = g.op("Concat", [latent, obs], axis=1)
        actions = g.mlp(x, p["actor"])
    elif family == "moe_ng_cts":
        mask = np.nonzero(np.asarray(obs_no_goal_mask))[0]
        ng_idx = np.concatenate([f * num_obs + mask for f in range(L)])
        expert_in = g.gather_cols(hist, ng_idx, hint="hist_ng")
        latent, weights = g.moe_latent(hist, expert_in, p["student_encoder"])
        x = g.op("Concat", [latent, obs], axis=1)
        actions = g.mlp(x, p["actor"])
    elif family == "ac_moe_cts":
        latent = g.l2norm(g.mlp(hist, p["student_encoder"]))
        x = g.op("Concat", [latent, obs], axis=1)
        actions, weights = g.moe_latent(x, x, p["actor"], normalize=False)
    elif family == "dual_moe_cts":
        latent, _sw = g.moe_latent(hist, hist, p["student_encoder"]["moe"])
        x = g.op("Concat", [latent, obs], axis=1)
        actions, weights = g.moe_latent(x, x, p["actor"], normalize=False)
    elif family == "mcp_cts":
        mask = np.nonzero(np.asarray(obs_no_goal_mask))[0]
        latent = g.l2norm(g.mlp(hist, p["student_encoder"]))
        x = g.op("Concat", [latent, obs], axis=1)
        obs_ng = g.gather_cols(obs, mask, hint="obs_ng")
        x_ng = g.op("Concat", [latent, obs_ng], axis=1)
        gate = g.mlp(x, p["actor"]["gating"])
        weights = g.op("Sigmoid", [gate], hint="weights")
        feats = g.mlp(x_ng, p["actor"]["experts"]["backbone"], final_act=True)
        head_w = np.asarray(p["actor"]["experts"]["head_kernel"])  # (E,H,2A)
        head_b = np.asarray(p["actor"]["experts"]["head_bias"])
        E, H, O2 = head_w.shape
        A = O2 // 2
        inv_acc = mu_acc = None
        for e in range(E):
            fe = g.gather_cols(feats, np.arange(e * H, (e + 1) * H),
                               hint=f"feat{e}")
            oe = g.gemm(fe, head_w[e], head_b[e], hint=f"expert{e}")
            mu_e = g.gather_cols(oe, np.arange(A), hint=f"mu{e}")
            ls_e = g.gather_cols(oe, np.arange(A, 2 * A), hint=f"ls{e}")
            ls_e = g.op("Clip", [ls_e,
                                 g.const(np.asarray(-5.0, np.float32)),
                                 g.const(np.asarray(2.0, np.float32))])
            var_e = g.op("Exp", [g.op(
                "Mul", [ls_e, g.const(np.asarray(2.0, np.float32))])])
            var_e = g.op("Add", [var_e,
                                 g.const(np.asarray(1e-9, np.float32))])
            we = g.gather_cols(weights, np.asarray([e]), hint=f"w{e}")
            inv_e = g.op("Div", [we, var_e])
            mu_w = g.op("Mul", [inv_e, mu_e])
            inv_acc = inv_e if inv_acc is None else g.op("Add",
                                                         [inv_acc, inv_e])
            mu_acc = mu_w if mu_acc is None else g.op("Add", [mu_acc, mu_w])
        inv_acc = g.op("Add", [inv_acc, g.const(np.asarray(1e-9, np.float32))])
        var_total = g.op("Div", [g.const(np.asarray(1.0, np.float32)), inv_acc])
        actions = g.op("Mul", [var_total, mu_acc], hint="actions")
    else:
        raise ValueError(f"unsupported family {family}")

    g.rename(actions, "actions")
    g.add_output("actions", (1, 12))
    if weights is not None:
        g.rename(weights, "weights")
        # E differs per family; shape is advisory in ONNX
        g.add_output("weights", (1, 8))
    # latent is exported by the moe families only (reference
    # forward_moe_*_cts return it; forward_cts and forward_mcp_cts do not)
    if latent is not None and family not in ("cts", "mcp_cts"):
        g.rename(latent, "latent")
        g.add_output("latent", (1, 32))
    return g.serialize()


def export_policy_as_onnx_native(params, family: str, out_dir: str,
                                 filename: str = "policy.onnx",
                                 num_obs: int = 45, history_length: int = 5,
                                 obs_no_goal_mask=None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    blob = build_policy_onnx(params, family, num_obs, history_length,
                             obs_no_goal_mask)
    path = os.path.join(out_dir, filename)
    with open(path, "wb") as f:
        f.write(blob)
    return path


# ---------------------------------------------------------------------------
# Numpy interpreter (verification-grade runtime for the emitted op set)
# ---------------------------------------------------------------------------


def _parse_tensor(buf: bytes):
    f = _parse(buf)
    dims = [int(d) for d in f.get(1, [])]
    dtype = int(f.get(2, [FLOAT])[0])
    name = f.get(8, [b""])[0].decode()
    if 9 in f:
        raw = f[9][0]
        arr = np.frombuffer(raw, np.float32 if dtype == FLOAT else np.int64)
    elif dtype == FLOAT:
        arr = np.asarray(f.get(4, []), np.float32)
    else:
        arr = np.asarray(f.get(7, []), np.int64)
    return name, arr.reshape(dims)


def _parse_attrs(raws):
    attrs = {}
    for raw in raws:
        f = _parse(raw)
        name = f[1][0].decode()
        atype = int(f.get(20, [0])[0])
        def _signed(v):
            v = int(v)
            return v - (1 << 64) if v >= (1 << 63) else v
        if atype == ATTR_FLOAT:
            attrs[name] = float(f[2][0])
        elif atype == ATTR_INT:
            attrs[name] = _signed(f[3][0])
        elif atype == ATTR_INTS:
            attrs[name] = [_signed(v) for v in f.get(8, [])]
        # other attr types unused by our graphs
    return attrs


class OnnxPolicy:
    """Load + execute a (this-module-generated or similarly simple) ONNX
    model with numpy. Supports the op set emitted above."""

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (str, os.PathLike)):
            with open(path_or_bytes, "rb") as f:
                blob = f.read()
        else:
            blob = path_or_bytes
        model = _parse(blob)
        graph = _parse(model[7][0])
        self.name = graph.get(2, [b""])[0].decode()
        self.inits = dict(_parse_tensor(t) for t in graph.get(5, []))
        self.input_names = [
            _parse(v)[1][0].decode() for v in graph.get(11, [])]
        self.output_names = [
            _parse(v)[1][0].decode() for v in graph.get(12, [])]
        self.nodes = []
        for raw in graph.get(1, []):
            f = _parse(raw)
            self.nodes.append({
                "op": f[4][0].decode(),
                "inputs": [s.decode() for s in f.get(1, [])],
                "outputs": [s.decode() for s in f.get(2, [])],
                "attrs": _parse_attrs(f.get(5, [])),
            })

    def __call__(self, *inputs):
        env: Dict[str, np.ndarray] = dict(self.inits)
        for name, arr in zip(self.input_names, inputs):
            env[name] = np.asarray(arr, np.float32)
        for n in self.nodes:
            x = [env[i] for i in n["inputs"]]
            a = n["attrs"]
            op = n["op"]
            if op == "Gemm":
                w = x[1].T if a.get("transB") else x[1]
                y = x[0] @ w + x[2]
            elif op == "Elu":
                y = np.where(x[0] > 0, x[0], np.expm1(np.minimum(x[0], 0.0)))
            elif op == "Relu":
                y = np.maximum(x[0], 0)
            elif op == "Tanh":
                y = np.tanh(x[0])
            elif op == "Sigmoid":
                y = 1.0 / (1.0 + np.exp(-x[0]))
            elif op == "Softmax":
                e = np.exp(x[0] - x[0].max(axis=-1, keepdims=True))
                y = e / e.sum(axis=-1, keepdims=True)
            elif op == "Gather":
                y = np.take(x[0], x[1].astype(np.int64), axis=a.get("axis", 0))
            elif op == "Concat":
                y = np.concatenate(x, axis=a["axis"])
            elif op == "Mul":
                y = x[0] * x[1]
            elif op == "Add":
                y = x[0] + x[1]
            elif op == "Sub":
                y = x[0] - x[1]
            elif op == "Div":
                y = x[0] / x[1]
            elif op == "Sqrt":
                y = np.sqrt(x[0])
            elif op == "Exp":
                y = np.exp(x[0])
            elif op == "Max":
                y = np.maximum(x[0], x[1])
            elif op == "Clip":
                y = np.clip(x[0], x[1] if len(x) > 1 else None,
                            x[2] if len(x) > 2 else None)
            elif op == "ReduceSum":
                axes = tuple(a.get("axes", [])) or None
                y = x[0].sum(axis=axes, keepdims=bool(a.get("keepdims", 1)))
            elif op == "Identity":
                y = x[0]
            else:
                raise NotImplementedError(f"op {op}")
            env[n["outputs"][0]] = np.asarray(y, np.float32) \
                if np.asarray(y).dtype != np.int64 else y
        outs = [env[o] for o in self.output_names]
        return outs[0] if len(outs) == 1 else tuple(outs)
