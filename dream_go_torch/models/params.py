"""Weights: BN folding, the ``dream_go.json`` format, and the bridge from
the JAX package's parameter trees.

Port of `dream_go_tpu/models/params.py` (``load_json``, ``dump_json``,
``decode_entry``, ``decode_raw``, ``fold_params``).  Parameter trees here
are nested dicts of numpy arrays in the flax layout (conv kernels HWIO,
dense kernels [in, out]); :func:`to_state_dict` turns a folded tree into
the ``state_dict`` of :class:`dream_go_torch.models.tower.Tower` (conv
OIHW, linear [out, in]), and :func:`from_train_tree` /
:func:`to_train_tree` turn a training tree (``params`` and
``batch_stats``) into the ``state_dict`` of
:class:`dream_go_torch.models.tower.TrainTower` and back.

BN folding (scale fixed at 1, `batch_norm.py:42`):
``w' = w / sqrt(var + 1e-3)``, ``b' = offset - mean / sqrt(var + 1e-3)``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..config import ModelConfig
from ..utils import b85

_EPS = 1e-3


def _fold_conv(conv, bn, stats):
    std = np.sqrt(np.asarray(stats["var"]) + _EPS)
    kernel = np.asarray(conv["kernel"]) / std
    bias = np.asarray(bn["bias"]) - np.asarray(stats["mean"]) / std
    return {"kernel": kernel, "bias": bias}


def fold_params(cfg: ModelConfig, params, batch_stats):
    """Training params (+ running stats) -> folded inference params."""
    def fold(scope_p, scope_s):
        return _fold_conv(scope_p["conv"], scope_p["bn"], scope_s["bn"])

    out = {"upsample": {"conv": fold(params["upsample"],
                                     batch_stats["upsample"])}}
    for i in range(cfg.num_blocks):
        name = f"residual_{i:02d}"
        out[name] = {
            "conv_1": {"conv": fold(params[name]["conv_1"],
                                    batch_stats[name]["conv_1"])},
            "conv_2": {"conv": fold(params[name]["conv_2"],
                                    batch_stats[name]["conv_2"])},
            "alpha": np.clip(np.asarray(params[name]["alpha"]), 0.0, 1.0),
        }
    out["policy"] = {
        "conv_1": {"conv": fold(params["policy"]["conv_1"],
                                batch_stats["policy"]["conv_1"])},
        "linear_1": {k: np.asarray(v)
                     for k, v in params["policy"]["linear_1"].items()},
    }
    out["value"] = {
        "conv_1": {"conv": fold(params["value"]["conv_1"],
                                batch_stats["value"]["conv_1"])},
        "conv_2": {k: np.asarray(v)
                   for k, v in params["value"]["conv_2"].items()},
        "linear_2": {k: np.asarray(v)
                     for k, v in params["value"]["linear_2"].items()},
    }
    return out


def _conv_sd(prefix: str, scope) -> dict:
    k = np.asarray(scope["kernel"], np.float32)
    return {f"{prefix}.weight": torch.tensor(k.transpose(3, 2, 0, 1)),
            f"{prefix}.bias": torch.tensor(
                np.asarray(scope["bias"], np.float32))}


def _dense_sd(prefix: str, scope) -> dict:
    k = np.asarray(scope["kernel"], np.float32)
    return {f"{prefix}.weight": torch.tensor(k.T),
            f"{prefix}.bias": torch.tensor(
                np.asarray(scope["bias"], np.float32))}


def to_state_dict(cfg: ModelConfig, folded) -> dict:
    """Folded flax-layout tree -> :class:`Tower` ``state_dict``."""
    sd = _conv_sd("upsample", folded["upsample"]["conv"])
    for i in range(cfg.num_blocks):
        src = folded[f"residual_{i:02d}"]
        sd.update(_conv_sd(f"blocks.{i}.conv_1", src["conv_1"]["conv"]))
        sd.update(_conv_sd(f"blocks.{i}.conv_2", src["conv_2"]["conv"]))
        sd[f"blocks.{i}.alpha"] = torch.tensor(
            float(np.clip(np.asarray(src["alpha"]), 0.0, 1.0)))
    sd.update(_conv_sd("policy_conv", folded["policy"]["conv_1"]["conv"]))
    sd.update(_dense_sd("policy_linear", folded["policy"]["linear_1"]))
    sd.update(_conv_sd("value_conv", folded["value"]["conv_1"]["conv"]))
    sd.update(_conv_sd("ownership_conv", folded["value"]["conv_2"]))
    sd.update(_dense_sd("value_linear", folded["value"]["linear_2"]))
    return sd


def from_jax_params(cfg: ModelConfig, params, batch_stats=None) -> dict:
    """The JAX package's flax trees (as numpy arrays) -> ``state_dict``.

    With ``batch_stats`` the training-form tree is BN-folded first; without
    (or empty) ``params`` is taken as already folded (``Tower(folded=True)``
    or :func:`load_json` output).
    """
    folded = fold_params(cfg, params, batch_stats) if batch_stats \
        else params
    return to_state_dict(cfg, folded)


def _train_layout(cfg: ModelConfig):
    """``(TrainTower prefix, flax scope path, kind)`` of every layer."""
    yield "upsample", ("upsample",), "bnconv"
    for i in range(cfg.num_blocks):
        scope = f"residual_{i:02d}"
        yield f"blocks.{i}.conv_1", (scope, "conv_1"), "bnconv"
        yield f"blocks.{i}.conv_2", (scope, "conv_2"), "bnconv"
        yield f"blocks.{i}.alpha", (scope, "alpha"), "alpha"
    yield "policy_conv", ("policy", "conv_1"), "bnconv"
    yield "policy_linear", ("policy", "linear_1"), "dense"
    yield "value_conv", ("value", "conv_1"), "bnconv"
    yield "ownership_conv", ("value", "conv_2"), "conv"
    yield "value_linear", ("value", "linear_2"), "dense"


def _scope(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def from_train_tree(cfg: ModelConfig, params, batch_stats) -> dict:
    """The JAX package's training trees (``params`` and ``batch_stats``,
    as numpy arrays) -> :class:`TrainTower` ``state_dict``."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    sd = {}
    for prefix, path, kind in _train_layout(cfg):
        p = _scope(params, path)
        if kind == "bnconv":
            st = _scope(batch_stats, path)["bn"]
            sd[f"{prefix}.conv.weight"] = t(
                np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1))
            sd[f"{prefix}.bn.bias"] = t(p["bn"]["bias"])
            sd[f"{prefix}.bn.mean"] = t(st["mean"])
            sd[f"{prefix}.bn.var"] = t(st["var"])
        elif kind == "alpha":
            sd[prefix] = t(p)
        else:
            sd.update(_conv_sd(prefix, p) if kind == "conv"
                      else _dense_sd(prefix, p))
    return sd


def to_train_tree(cfg: ModelConfig, sd: dict):
    """:class:`TrainTower` ``state_dict`` (or any map of those names to
    tensors) -> the JAX package's ``(params, batch_stats)`` trees, float32
    numpy in the flax layout."""
    a = lambda name: sd[name].detach().float().cpu().numpy()
    params, stats = {}, {}

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    for prefix, path, kind in _train_layout(cfg):
        if kind == "bnconv":
            put(params, path, {
                "conv": {"kernel": a(f"{prefix}.conv.weight")
                         .transpose(2, 3, 1, 0)},
                "bn": {"bias": a(f"{prefix}.bn.bias")}})
            put(stats, path, {"bn": {"mean": a(f"{prefix}.bn.mean"),
                                     "var": a(f"{prefix}.bn.var")}})
        elif kind == "alpha":
            put(params, path, a(prefix))
        elif kind == "conv":
            put(params, path, {"kernel": a(f"{prefix}.weight")
                               .transpose(2, 3, 1, 0),
                               "bias": a(f"{prefix}.bias")})
        else:
            put(params, path, {"kernel": a(f"{prefix}.weight").T,
                               "bias": a(f"{prefix}.bias")})
    return params, stats


def fold_train(cfg: ModelConfig, sd: dict) -> dict:
    """:class:`TrainTower` ``state_dict`` -> the folded :class:`Tower`
    ``state_dict`` (running statistics folded into the conv biases)."""
    return to_state_dict(cfg, fold_params(cfg, *to_train_tree(cfg, sd)))


def _entry(values: np.ndarray, ttype: str = "f2", scale: float = 1.0) -> dict:
    values = np.asarray(values)
    if ttype == "f2":
        payload = values.astype(np.float16)
        if payload.size % 2:  # b85 groups are 4 bytes = two f16
            payload = np.concatenate([payload.reshape(-1),
                                      np.zeros(1, np.float16)])
    elif ttype == "f4":
        payload = values.astype(np.float32)
    elif ttype == "i4":
        payload = values.astype(np.int32)
    elif ttype == "i1":
        payload = values.astype(np.int8)
    else:
        raise ValueError(f"unknown tensor type {ttype}")
    return {
        # scale is a single b85 f32, per loader.rs:53-57
        "s": b85.encode_bytes(np.float32(scale).tobytes()),
        "t": ttype,
        "v": b85.encode_bytes(payload.tobytes()),
    }


def _hwio_to_oihw(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))


def dump_json(cfg: ModelConfig, params, batch_stats) -> str:
    """Serialize training trees to the reference weights JSON (BN folded,
    conv kernels OIHW, dense kernels [out, in], f16 payloads)."""
    folded = fold_params(cfg, params, batch_stats)
    out = {
        "num_channels:0": _entry(np.asarray([cfg.num_channels]), "i4"),
        "num_samples:0": _entry(np.asarray([cfg.num_samples]), "i4"),
        "num_blocks:0": _entry(np.asarray([cfg.num_blocks]), "i4"),
        # the input contract: were planes 30/31 populated in training?
        "ladder_features:0": _entry(
            np.asarray([int(cfg.ladder_features)]), "i4"),
    }

    def conv(name, scope):
        out[f"{name}:0"] = _entry(_hwio_to_oihw(scope["conv"]["kernel"]))
        out[f"{name}/offset:0"] = _entry(scope["conv"]["bias"])

    conv("01_upsample/conv_1", folded["upsample"])
    for i in range(cfg.num_blocks):
        src = folded[f"residual_{i:02d}"]
        conv(f"{i + 2:02d}_residual/conv_1", src["conv_1"])
        conv(f"{i + 2:02d}_residual/conv_2", src["conv_2"])
        out[f"{i + 2:02d}_residual/alpha:0"] = _entry(
            np.asarray([src["alpha"]]), "f4")
    j = cfg.num_blocks + 2
    conv(f"{j:02d}p_policy/conv_1", folded["policy"]["conv_1"])
    out[f"{j:02d}p_policy/linear_1:0"] = _entry(
        np.asarray(folded["policy"]["linear_1"]["kernel"]).T)  # [362, 361*s]
    out[f"{j:02d}p_policy/linear_1/offset:0"] = _entry(
        folded["policy"]["linear_1"]["bias"])
    conv(f"{j:02d}v_value/conv_1", folded["value"]["conv_1"])
    out[f"{j:02d}v_value/linear_2:0"] = _entry(
        np.asarray(folded["value"]["linear_2"]["kernel"]).T)  # [1, 722]
    out[f"{j:02d}v_value/linear_2/offset:0"] = _entry(
        folded["value"]["linear_2"]["bias"])
    # the ownership head (the reference loader ignores it)
    out[f"{j:02d}v_value/conv_2:0"] = _entry(
        _hwio_to_oihw(np.asarray(folded["value"]["conv_2"]["kernel"])))
    out[f"{j:02d}v_value/conv_2/offset:0"] = _entry(
        folded["value"]["conv_2"]["bias"])
    return json.dumps(out)


def decode_raw(text: str) -> dict:
    """Every tensor of a weights JSON as a name -> float32 array map (no
    model reassembly), for ``--print``."""
    return {name: decode_entry(entry)
            for name, entry in json.loads(text).items()}


def decode_entry(entry: dict) -> np.ndarray:
    """Decode one ``{"s", "t", "v"}`` weights-JSON entry to float32 values
    (`loader.rs:36-116`): ``s`` a b85 f32 scale, ``t`` the payload type,
    ``v`` the b85 payload; float payloads are multiplied by the scale."""
    dtype = {"f2": np.float16, "f4": np.float32,
             "i4": np.int32, "i1": np.int8}[entry["t"]]
    values = b85.decode(entry["v"], dtype).astype(np.float32)
    scale = b85.decode(entry["s"], np.float32)[0]
    if entry["t"] in ("i1", "i4") and scale != 0:
        return values
    return values * (scale if scale != 0 else 1.0)


def load_json(text: str):
    """Parse a weights JSON into (ModelConfig, folded params tree)."""
    raw = json.loads(text)
    dec = decode_entry
    num_channels = int(dec(raw["num_channels:0"])[0])
    num_samples = int(dec(raw["num_samples:0"])[0])
    num_blocks = 0
    while f"{num_blocks + 2:02d}_residual/conv_1:0" in raw:
        num_blocks += 1
    ladders = ("ladder_features:0" not in raw
               or bool(int(dec(raw["ladder_features:0"])[0])))
    cfg = ModelConfig(num_channels=num_channels, num_blocks=num_blocks,
                      num_samples=num_samples, ladder_features=ladders)

    def conv(name, out_c, in_c, kh=3, kw=3):
        k = dec(raw[f"{name}:0"])[: out_c * in_c * kh * kw]
        k = k.reshape(out_c, in_c, kh, kw).transpose(2, 3, 1, 0)  # HWIO
        b = dec(raw[f"{name}/offset:0"])[:out_c]
        return {"conv": {"kernel": k, "bias": b}}

    c, s = cfg.num_channels, cfg.num_samples
    params = {"upsample": conv("01_upsample/conv_1", c, cfg.num_features)}
    for i in range(num_blocks):
        params[f"residual_{i:02d}"] = {
            "conv_1": conv(f"{i + 2:02d}_residual/conv_1", c, c),
            "conv_2": conv(f"{i + 2:02d}_residual/conv_2", c, c),
            "alpha": dec(raw[f"{i + 2:02d}_residual/alpha:0"])[0],
        }
    j = num_blocks + 2
    pol_k = dec(raw[f"{j:02d}p_policy/linear_1:0"])[: 362 * 361 * s]
    params["policy"] = {
        "conv_1": conv(f"{j:02d}p_policy/conv_1", s, c),
        "linear_1": {
            "kernel": pol_k.reshape(362, 361 * s).T,
            "bias": dec(raw[f"{j:02d}p_policy/linear_1/offset:0"])[:362],
        },
    }
    val_k = dec(raw[f"{j:02d}v_value/linear_2:0"])[:722]
    params["value"] = {
        "conv_1": conv(f"{j:02d}v_value/conv_1", 2, c),
        "linear_2": {
            "kernel": val_k.reshape(1, 722).T,
            "bias": dec(raw[f"{j:02d}v_value/linear_2/offset:0"])[:1],
        },
    }
    if f"{j:02d}v_value/conv_2:0" in raw:
        params["value"]["conv_2"] = {
            "kernel": dec(raw[f"{j:02d}v_value/conv_2:0"])[:2]
            .reshape(1, 2, 1, 1).transpose(2, 3, 1, 0),
            "bias": dec(raw[f"{j:02d}v_value/conv_2/offset:0"])[:1],
        }
    else:  # reference dumps lack the ownership head
        params["value"]["conv_2"] = {
            "kernel": np.zeros((1, 1, 2, 1), np.float32),
            "bias": np.zeros(1, np.float32),
        }
    return cfg, params
