"""Carry JAX-package weights into the port.

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
