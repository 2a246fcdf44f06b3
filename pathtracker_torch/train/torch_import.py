"""Carry JAX-package weights into the port, and the port's back.

pathtracker_tpu names its flat params after the reference's state_dict keys
and stores them in JAX layouts ([Cin, Cout] matmul kernels, HWIO convs, [C]
scalars); the port's modules ARE the reference layout. So the JAX flat
params map onto the port's ``state_dict`` by the rules of
pathtracker_tpu/train/torch_import.py::export_reference_state_dict
(:633-690), copied here:

    preproc_kernel        -> preproc.weight        [3,C]   -> [C,3,1,1,1]
    <gate>_kernel         -> unit1.<gate>.weight   [I,O]   -> [O,I,1,1]
    <gate>_bias           -> unit1.<gate>.bias
    w_inh / w_exc         -> unit1.w_inh / w_exc   HWIO    -> OIHW
    alpha|mu|gamma|kappa|w -> unit1.<name>          [C]     -> [C,1,1]
    bn<i>_{scale,bias}    -> unit1.bn.<i>.{weight,bias}
    readout_conv_kernel   -> readout_conv.weight   [C,1]   -> [1,C,1,1]
    target_conv_kernel    -> target_conv.weight    HWIO    -> OIHW
    readout_dense_kernel  -> readout_dense.weight  [in,out] -> [out,in]

The result loads into the port's InT with ``strict=True``.
``to_jax_params`` is the inverse: a ``state_dict`` (or any {name: tensor}
keyed like one, such as gradients) back to JAX names and layouts.

``rntsm`` (models/tsm_resnet.py) keeps a NESTED flax tree, one ``_ConvBN``
({kernel, bn_scale, bn_bias}) per conv; it maps onto the reference
resnet_TSM state_dict by the rules of pathtracker_tpu/train/torch_import.py
::export_tsm_resnet_state_dict / import_tsm_resnet_state_dict (:384-463),
copied here:

    stem                          -> conv1.weight, bn1.{weight,bias}
    layerL_B/convI                -> layerL.B.convI.weight, layerL.B.bnI.*
    layerL_B/down                 -> layerL.B.downsample.{0.weight, 1.*}
    chnl_reduction                -> chnl_reduction.{0.weight, 1.*}
    flow_refinement/dwN | pwN     -> flow_refinement.convN.{0.weight, 1.*} | {3.weight, 4.*}
    fc1_kernel [C,cls], fc1_bias  -> fc1.weight [cls,C,1], fc1.bias

with conv kernels HWIO -> OIHW (a depthwise [k,k,1,C] becomes [C,1,k,k] by
the same transpose). ``state_dict_from_jax`` picks the mapping by model
name; ``to_jax_params`` takes either family's ``state_dict`` and tells them
apart by their keys.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_EXPORT_RULES = [
    (re.compile(r"^preproc_kernel$"), lambda m: "preproc.weight"),
    (re.compile(r"^preproc_bias$"), lambda m: "preproc.bias"),
    (re.compile(r"^conv0_kernel$"), lambda m: "conv0.weight"),
    (re.compile(r"^conv0_bias$"), lambda m: "conv0.bias"),
    (re.compile(r"^conv6_kernel$"), lambda m: "conv6.weight"),
    (re.compile(r"^conv6_bias$"), lambda m: "conv6.bias"),
    (re.compile(r"^bn_scale$"), lambda m: "bn.weight"),
    (re.compile(r"^bn_bias$"), lambda m: "bn.bias"),
    (re.compile(r"^bn(\d+)_scale$"), lambda m: f"unit1.bn.{m.group(1)}.weight"),
    (re.compile(r"^bn(\d+)_bias$"), lambda m: f"unit1.bn.{m.group(1)}.bias"),
    (re.compile(r"^readout_conv_kernel$"), lambda m: "readout_conv.weight"),
    (re.compile(r"^readout_conv_bias$"), lambda m: "readout_conv.bias"),
    (re.compile(r"^target_conv_kernel$"), lambda m: "target_conv.weight"),
    (re.compile(r"^target_conv_bias$"), lambda m: "target_conv.bias"),
    (re.compile(r"^readout_dense_kernel$"), lambda m: "readout_dense.weight"),
    (re.compile(r"^readout_dense_bias$"), lambda m: "readout_dense.bias"),
    (re.compile(r"^(w_inh|w_exc|alpha|mu|gamma|kappa|w)$"),
     lambda m: f"unit1.{m.group(1)}"),
    (re.compile(r"^([A-Za-z_0-9]+)_kernel$"), lambda m: f"unit1.{m.group(1)}.weight"),
    (re.compile(r"^([A-Za-z_0-9]+)_bias$"), lambda m: f"unit1.{m.group(1)}.bias"),
]


def export_reference_state_dict(params: dict) -> dict:
    """JAX flat params ({name: array}, JAX names and layouts) -> the port's
    (the reference's) ``state_dict`` of f32 CPU tensors."""
    out = {}
    for name, value in params.items():
        arr = np.asarray(value, dtype=np.float32)
        key = None
        for pattern, fn in _EXPORT_RULES:
            m = pattern.match(name)
            if m:
                key = fn(m)
                break
        if key is None:
            raise ValueError(f"no reference counterpart for parameter {name!r}")
        if key == "preproc.weight":
            arr = arr.T[:, :, None, None, None]  # [3,C] -> [C,3,1,1,1]
        elif key == "conv6.weight":
            arr = arr.T[:, :, None, None]  # [C,2] matmul -> [2,C,1,1] conv
        elif key == "readout_conv.weight" or (
                key.endswith(".weight") and key.startswith("unit1.")
                and arr.ndim == 2 and "dense" not in key):
            arr = arr.T[:, :, None, None]  # [I,O] matmul -> [O,I,1,1] conv
        elif key == "readout_dense.weight":
            arr = arr.T  # [in,out] -> [out,in]
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif key.startswith("unit1.") and arr.ndim == 1 and re.search(
                r"unit1\.(alpha|mu|gamma|kappa|w)$", key):
            arr = arr[:, None, None]  # [C] -> [C,1,1]
        out[key] = torch.tensor(np.ascontiguousarray(arr))  # a copy: checkpoint arrays are read-only
    return out


_IMPORT_RULES = [
    (re.compile(r"^unit1\.bn\.(\d+)\.weight$"), lambda m: f"bn{m.group(1)}_scale"),
    (re.compile(r"^unit1\.bn\.(\d+)\.bias$"), lambda m: f"bn{m.group(1)}_bias"),
    (re.compile(r"^bn\.weight$"), lambda m: "bn_scale"),
    (re.compile(r"^bn\.bias$"), lambda m: "bn_bias"),
    (re.compile(r"^unit1\.(w_inh|w_exc|alpha|mu|gamma|kappa|w)$"), lambda m: m.group(1)),
    (re.compile(r"^(?:unit1\.)?([A-Za-z_0-9]+)\.weight$"), lambda m: f"{m.group(1)}_kernel"),
    (re.compile(r"^(?:unit1\.)?([A-Za-z_0-9]+)\.bias$"), lambda m: f"{m.group(1)}_bias"),
]


def to_jax_params(state_dict: dict) -> dict:
    """The port's ``state_dict`` (or tensors keyed like it, such as
    gradients) -> JAX params {name: f32 numpy array}, flat for the InT
    family and nested for ``rntsm``, in the JAX names and layouts: the
    inverse of ``export_reference_state_dict``."""
    if looks_like_tsm_resnet_state_dict(state_dict):
        return import_tsm_resnet_state_dict(state_dict)
    out = {}
    for key, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        name = None
        for pattern, fn in _IMPORT_RULES:
            m = pattern.match(key)
            if m:
                name = fn(m)
                break
        if name is None:
            raise ValueError(f"no JAX counterpart for state_dict key {key!r}")
        if key == "preproc.weight":
            arr = arr[:, :, 0, 0, 0].T  # [C,3,1,1,1] -> [3,C]
        elif key == "readout_dense.weight":
            arr = arr.T  # [out,in] -> [in,out]
        elif arr.ndim == 4 and arr.shape[2:] == (1, 1) and key != "target_conv.weight":
            arr = arr[:, :, 0, 0].T  # [O,I,1,1] conv -> [I,O] matmul
        elif arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif arr.ndim == 3 and arr.shape[1:] == (1, 1):
            arr = arr[:, 0, 0]  # [C,1,1] -> [C]
        out[name] = np.ascontiguousarray(arr)
    return out


def state_dict_from_jax(model_name: str, params: dict) -> dict:
    """JAX params of ``model_name`` -> the port's ``state_dict``, by the
    model's own mapping."""
    if model_name == "rntsm":
        return export_tsm_resnet_state_dict(params)
    return export_reference_state_dict(params)


# --- TSM-ResNet: nested flax tree <-> reference resnet_TSM state_dict --------

def looks_like_tsm_resnet_state_dict(state_dict) -> bool:
    keys = {k.split("module.")[-1] for k in state_dict if isinstance(k, str)}
    return ("conv1.weight" in keys
            and any(k.startswith("layer1.0.conv1.weight") for k in keys))


def _tsm_modules(params: dict):
    """(JAX path of a _ConvBN, state_dict key of its conv weight, state_dict
    prefix of its BN) for every _ConvBN in a nested TSMResNet tree."""
    for name, value in params.items():
        if name in ("fc1_kernel", "fc1_bias"):
            continue
        if name == "stem":
            yield (name,), "conv1.weight", "bn1"
        elif name == "chnl_reduction":
            yield (name,), "chnl_reduction.0.weight", "chnl_reduction.1"
        elif name == "flow_refinement":
            for sub in value:
                m = re.match(r"^(dw|pw)(\d)$", sub)
                if not m:
                    raise ValueError(f"unknown flow_refinement member {sub!r}")
                conv, bn = (0, 1) if m.group(1) == "dw" else (3, 4)
                base = f"flow_refinement.conv{m.group(2)}"
                yield (name, sub), f"{base}.{conv}.weight", f"{base}.{bn}"
        elif re.match(r"^layer\d_\d+$", name):
            base = name.replace("_", ".")
            for sub in value:
                m = re.match(r"^conv(\d)$", sub)
                if m:
                    yield ((name, sub), f"{base}.conv{m.group(1)}.weight",
                           f"{base}.bn{m.group(1)}")
                elif sub == "down":
                    yield ((name, sub), f"{base}.downsample.0.weight",
                           f"{base}.downsample.1")
                else:
                    raise ValueError(f"unknown block member {name}/{sub}")
        else:
            raise ValueError(f"no resnet_TSM counterpart for {name!r}")


def export_tsm_resnet_state_dict(params: dict) -> dict:
    """Nested TSMResNet params (JAX names and layouts) -> the port's (the
    reference resnet_TSM's) ``state_dict`` of f32 CPU tensors."""
    def tensor(arr):
        # a copy: checkpoint arrays are read-only
        return torch.tensor(np.ascontiguousarray(np.asarray(arr, dtype=np.float32)))

    out = {}
    for path, conv_key, bn in _tsm_modules(params):
        mod = params
        for part in path:
            mod = mod[part]
        out[conv_key] = tensor(np.asarray(mod["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
        out[f"{bn}.weight"] = tensor(mod["bn_scale"])
        out[f"{bn}.bias"] = tensor(mod["bn_bias"])
    out["fc1.weight"] = tensor(np.asarray(params["fc1_kernel"]).T[..., None])  # [C,cls] -> [cls,C,1]
    out["fc1.bias"] = tensor(params["fc1_bias"])
    return out


_TSM_IMPORT_RULES = [
    (re.compile(r"^conv1\.weight$"), lambda m: ("stem", "kernel")),
    (re.compile(r"^bn1\.(weight|bias)$"), lambda m: ("stem", m.group(1))),
    (re.compile(r"^layer(\d)\.(\d+)\.conv(\d)\.weight$"),
     lambda m: (f"layer{m.group(1)}_{m.group(2)}", f"conv{m.group(3)}", "kernel")),
    (re.compile(r"^layer(\d)\.(\d+)\.bn(\d)\.(weight|bias)$"),
     lambda m: (f"layer{m.group(1)}_{m.group(2)}", f"conv{m.group(3)}", m.group(4))),
    (re.compile(r"^layer(\d)\.(\d+)\.downsample\.0\.weight$"),
     lambda m: (f"layer{m.group(1)}_{m.group(2)}", "down", "kernel")),
    (re.compile(r"^layer(\d)\.(\d+)\.downsample\.1\.(weight|bias)$"),
     lambda m: (f"layer{m.group(1)}_{m.group(2)}", "down", m.group(3))),
    (re.compile(r"^chnl_reduction\.0\.weight$"), lambda m: ("chnl_reduction", "kernel")),
    (re.compile(r"^chnl_reduction\.1\.(weight|bias)$"),
     lambda m: ("chnl_reduction", m.group(1))),
    (re.compile(r"^flow_refinement\.conv(\d)\.([03])\.weight$"),
     lambda m: ("flow_refinement",
                f"{'dw' if m.group(2) == '0' else 'pw'}{m.group(1)}", "kernel")),
    (re.compile(r"^flow_refinement\.conv(\d)\.([14])\.(weight|bias)$"),
     lambda m: ("flow_refinement",
                f"{'dw' if m.group(2) == '1' else 'pw'}{m.group(1)}", m.group(3))),
    (re.compile(r"^fc1\.weight$"), lambda m: ("fc1_kernel",)),
    (re.compile(r"^fc1\.bias$"), lambda m: ("fc1_bias",)),
]
_BN_LEAF = {"weight": "bn_scale", "bias": "bn_bias"}


def import_tsm_resnet_state_dict(state_dict: dict) -> dict:
    """The port's TSMResNet ``state_dict`` (or tensors keyed like it) ->
    the nested JAX tree of f32 numpy arrays: the inverse of
    ``export_tsm_resnet_state_dict``."""
    out = {}
    for key, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        path = None
        for pattern, fn in _TSM_IMPORT_RULES:
            m = pattern.match(key)
            if m:
                path = fn(m)
                break
        if path is None:
            raise ValueError(f"no TSMResNet counterpart for state_dict key {key!r}")
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif arr.ndim == 3:
            arr = arr[..., 0].T  # Conv1d head [cls,C,1] -> [C,cls]
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[_BN_LEAF.get(path[-1], path[-1])] = np.ascontiguousarray(arr)
    return out
