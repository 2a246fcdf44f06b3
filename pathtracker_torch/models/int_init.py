"""The JAX package's seeded InT init, drawn as flax draws it: the same
weights from the same seed in both packages (pathtracker_tpu/models/
int_circuit.py:258-298, models/common.py:31-45, ops/initializers.py).

``model.init(jax.random.key(seed), x)`` gives each ``self.param`` the key
``fold_in(key(seed), h)``, ``h`` the first four bytes of the SHA-1 of the
param's creation index in the module (1, 2, ...; flax's ``make_rng``
counter, ``_fold_in_static``), and each initializer draws from its key with
jax.random's partitionable Threefry (``data/prng.py``): ``uniform`` maps
the top 23 bits of each word into [1, 2), ``normal`` is sqrt(2) *
erfinv(uniform(nextafter(-1, 0), 1)) with XLA's f32 erfinv polynomial, and
the orthogonal kernels are QR of a normal matrix with Haar signs; XLA
contracts each multiply-add into one rounding, and so does this module.
Uniform draws are bit-equal to JAX's; normals differ by an ulp where XLA's
f32 log1p rounds otherwise than numpy's, and the orthogonal kernels by
~1e-6 of their largest entry (those ulps, and another library's QR):
tests/test_torch_int_init.py holds both. ``state_dict`` gives the draw in
InT's own names and layouts, which is all InT's constructor loads.

InT's plateau at chance (the canonical chain's stage A) lasts as long as
its init decides: from this draw at seed 0 the port leaves it when the JAX
package did; from torch draws of the same distributions at seeds 0-2 it
did not within the stage's 60 epochs (PERF.md, PR 16).
"""

from __future__ import annotations

import hashlib
import math
import re

import numpy as np
import torch

from pathtracker_torch.data import prng

F32 = np.float32
# XLA's f32 ErfInv (Giles' single-precision approximation), coefficients
# from the highest power down, for w = -log1p(-x^2) below and above 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def param_key(root: tuple[int, int], index: int) -> tuple[int, int]:
    """The key flax gives the ``index``-th param (1-based) of a module."""
    digest = hashlib.sha1(index.to_bytes((index.bit_length() + 7) // 8, "big")).digest()
    return prng.fold_in(root, int.from_bytes(digest[:4], "big"))


def _bits(k: tuple[int, int], n: int) -> np.ndarray:
    return prng.random_bits(k, n, "cpu").numpy().astype(np.uint32)


def uniform(k, shape, minval: float, maxval: float) -> np.ndarray:
    """jax.random.uniform(k, shape, float32, minval, maxval)."""
    n = math.prod(shape)
    floats = ((_bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)).view(F32) - F32(1.0)
    lo, hi = F32(minval), F32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo)).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to f32, as XLA's contracted multiply-add."""
    return (a.astype(np.float64) * np.float64(b) + np.float64(c)).astype(F32)


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    small = w < F32(5.0)
    w = np.where(small, w - F32(2.5), np.sqrt(w) - F32(3.0))
    p = np.where(small, F32(_ERFINV_LT5[0]), F32(_ERFINV_GE5[0]))
    for lt5, ge5 in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(small, F32(lt5), F32(ge5)))
    return np.where(np.abs(x) == F32(1.0), x * F32(np.inf), p * x).astype(F32)


def normal(k, shape) -> np.ndarray:
    """jax.random.normal(k, shape, float32)."""
    lo = np.nextafter(F32(-1.0), F32(0.0))
    return (F32(np.sqrt(2)) * _erfinv(uniform(k, shape, lo, 1.0))).astype(F32)


def _orthogonal_rows(k, rows: int, cols: int) -> np.ndarray:
    n, m = (rows, cols) if rows >= cols else (cols, rows)
    q, r = torch.linalg.qr(torch.from_numpy(normal(k, (n, m))))
    q = (q * torch.sign(torch.diagonal(r))[None, :]).numpy()
    return q.T if rows < cols else q


def _conv_default(k, shape):
    fan_in = math.prod(shape[:-1])
    return uniform(k, shape, -1.0 / np.sqrt(fan_in), 1.0 / np.sqrt(fan_in))


def _bias(fan_in: int):
    return lambda k, shape: uniform(k, shape, -1.0 / np.sqrt(fan_in), 1.0 / np.sqrt(fan_in))


def _orthogonal_matrix(k, shape):
    cin, cout = shape
    return _orthogonal_rows(k, cout, cin).T


def _orthogonal_conv(k, shape):
    kh, kw, cin, cout = shape
    w = _orthogonal_rows(k, cout, cin * kh * kw).reshape(cout, cin, kh, kw)
    return np.transpose(w, (2, 3, 1, 0))


def _chrono(timesteps: int):
    hi = max(float(timesteps - 1), 1.0 + 1e-6)
    return lambda k, shape: np.log(uniform(k, shape, 1.0, hi)).astype(F32)


def _constant(value: float):
    return lambda k, shape: np.full(shape, value, F32)


def jax_int_params(seed: int, dimensions: int, kernel_size: int, timesteps: int,
                   use_attention: bool = True, no_inh: bool = False,
                   lesions=frozenset()) -> dict:
    """InT's params {JAX name: f32 array in the JAX layout}, as the JAX
    package's ``init_model`` draws them at ``seed``: one entry a
    ``self.param`` call, in its order (lesioned scalars are not params)."""
    c, k = dimensions, kernel_size
    root = prng.key(seed)
    params: dict = {}

    def param(name, init, shape):
        params[name] = np.ascontiguousarray(init(param_key(root, len(seen) + 1), shape),
                                            dtype=F32)
        seen.append(name)
        return params[name]

    seen: list = []
    param("preproc_kernel", _conv_default, (3, c))
    param("preproc_bias", _bias(3), (c,))
    if use_attention:
        param("a_w_gate_kernel", _orthogonal_matrix, (c, c))
        param("a_u_gate_kernel", _orthogonal_matrix, (c, c))
        param("a_w_gate_bias", _constant(1.0), (c,))
        param("a_u_gate_bias", _constant(1.0), (c,))
        for name in ("i_w_gate_bias", "i_u_gate_bias", "e_w_gate_bias", "e_u_gate_bias"):
            param(name, _constant(-1.0), (c,))
    else:
        i_w_b = param("i_w_gate_bias", _chrono(timesteps), (c,))
        i_u_b = param("i_u_gate_bias", _chrono(timesteps), (c,))
        param("e_w_gate_bias", lambda _, s: -i_w_b, (c,))
        param("e_u_gate_bias", lambda _, s: -i_u_b, (c,))
    for name in ("i_w_gate_kernel", "i_u_gate_kernel", "e_w_gate_kernel", "e_u_gate_kernel"):
        param(name, _orthogonal_matrix, (c, c))
    param("w_exc", _orthogonal_conv, (k, k, c, c))
    if not no_inh:
        param("w_inh", _orthogonal_conv, (k, k, c, c))
        if "alpha" not in lesions:
            param("alpha", _constant(1.0), (c,))
        if "mu" not in lesions:
            param("mu", _constant(0.0), (c,))
    if "gamma" not in lesions:
        param("gamma", _constant(0.0), (c,))
    if "kappa" not in lesions:
        param("kappa", _constant(1.0), (c,))
    param("w", _constant(1.0), (c,))
    param("bn0_scale", _constant(0.1), (c,))
    param("bn0_bias", _constant(0.0), (c,))
    param("bn1_scale", _constant(0.1), (c,))
    param("bn1_bias", _constant(0.0), (c,))
    param("readout_conv_kernel", _conv_default, (c, 1))
    param("readout_conv_bias", _bias(c), (1,))
    param("target_conv_kernel", _conv_default, (5, 5, 2, 1))
    param("target_conv_bias", _constant(0.0), (1,))
    param("readout_dense_kernel", _conv_default, (1, 1))
    param("readout_dense_bias", _bias(1), (1,))
    return params


# The JAX layout of a kernel -> InT's module layout.
_KERNEL_LAYOUTS = {
    "preproc": lambda a: a.T[:, :, None, None, None],  # [3,C] -> Conv3d [C,3,1,1,1]
    "readout_conv": lambda a: a.T[:, :, None, None],  # [C,1] -> [1,C,1,1]
    "target_conv": lambda a: a.transpose(3, 2, 0, 1),  # HWIO -> OIHW
    "readout_dense": lambda a: a.T,  # [in,out] -> [out,in]
}


def state_dict(seed: int, dimensions: int, kernel_size: int, timesteps: int,
               use_attention: bool = True, no_inh: bool = False,
               lesions=frozenset()) -> dict:
    """``jax_int_params``' draw as InT's ``state_dict``: its keys (the
    reference's names) and layouts, f32 CPU tensors."""
    out = {}
    for name, arr in jax_int_params(seed, dimensions, kernel_size, timesteps,
                                    use_attention, no_inh, lesions).items():
        gate, bn = re.fullmatch(r"(\w+_gate)_(kernel|bias)", name), re.fullmatch(
            r"bn(\d)_(scale|bias)", name)
        if gate:
            key = f"unit1.{gate[1]}.{'weight' if gate[2] == 'kernel' else 'bias'}"
            arr = arr.T[:, :, None, None] if gate[2] == "kernel" else arr  # [I,O] -> [O,I,1,1]
        elif bn:
            key = f"unit1.bn.{bn[1]}.{'weight' if bn[2] == 'scale' else 'bias'}"
        elif name in ("w_exc", "w_inh"):
            key, arr = f"unit1.{name}", arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif name in ("alpha", "mu", "gamma", "kappa", "w"):
            key, arr = f"unit1.{name}", arr[:, None, None]  # [C] -> [C,1,1]
        else:
            module, kind = name.rsplit("_", 1)
            key = f"{module}.{'weight' if kind == 'kernel' else 'bias'}"
            arr = _KERNEL_LAYOUTS[module](arr) if kind == "kernel" else arr
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
