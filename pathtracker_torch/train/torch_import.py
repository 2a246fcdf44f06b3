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

The same rules serve ``fc``, the hGRU family, ``gru`` and ``convlstm``,
whose modules are named after the reference's state_dict keys too
(``conv0``, ``unit1.Wx<g>``, ``bn``, ``conv6``; ``unit1.conv_<g>``); the
port adds rules where the JAX package's export has none or gives a layout
no torch module takes: ClockHGRU's ``preproc_bn_*`` and ``clock_rate``,
FC's ``readout_*`` (a Linear), and hgru_v2's 1x1 ``target_conv``.
The result loads into the port's model with ``strict=True``.
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
the same transpose).

The rest of the zoo (``stlstm``, ``fflstm``, ``lrcn``, ``lrcn_last``,
``ffnet``) and the video ResNets map by the rule tables ``_ZOO_RULES`` and
``_video_resnet_rules``, one (JAX path, state_dict key, layout) triple a
parameter kind, read both ways: 3-D conv kernels THWIO <-> OITHW, 2-D ones
HWIO <-> OIHW, dense kernels and LSTM weights [in, out] <-> [out, in],
stlstm's LayerNorm affines [H, W, C] <-> [C, H, W]. The video ResNets'
state_dict is torchvision's (``import_video_resnet_state_dict`` takes a
torchvision checkpoint).

SlowFast and ``slow`` (models/slowfast.py) carry FAIR pyslowfast's
state_dict names, so one rule table (``_slowfast_rules``) maps the port,
FAIR checkpoints and the JAX tree, as
pathtracker_tpu/train/torch_import.py:466-627 does:

    slow_stem | fast_stem | stem  -> s1.pathway{0,1}_stem.{conv.weight, bn.*}
    fuse{j-1}                     -> s{j}_fuse.{conv_f2s.weight, bn.*}
    {slow,fast}_res{s}_{b}/{a,b,c} | res{s}_{b}/{a,b,c}
                                  -> s{s}.pathway{p}_res{b}.branch2.{a,b,c}{.weight,_bn.*}
    .../proj                      -> ...branch1.weight, branch1_bn.*
    nl_res{s}_{b}/{theta,phi,g,out} -> s{s}.pathway0_nonlocal{b}.conv_*.weight, bn.*
    head_kernel [F,cls], head_bias -> head.projection.{weight [cls,F], bias}

with conv kernels THWIO <-> OITHW. The transformers (``timesformer`` and
the ViT, ``performer``, ``lambda``) keep the JAX names with ``/`` as ``.``
and ``_kernel`` as ``.weight``, linears [in, out] <-> [out, in] and the
readout's conv HWIO <-> OIHW; ``favor_proj``, ``pos_emb`` and
``cls_token`` keep their layout.

The parallel modes' own parameters (parallel/moe.py, parallel/pipeline.py)
map too: the MoE bank ({router_w, w1, b1, w2, b2}) keeps JAX's names and
layouts, and a pipeline's stacked stages ({k, b} with a leading stage axis)
take the conv kernels' stacked HWIO <-> OIHW. A sharded run's parameters
come back to JAX names and layouts as ``to_jax_params(gather_params(s))``.

``state_dict_from_jax`` picks the mapping by model name, or by a layout
name of ``layout_of``; ``to_jax_params`` takes any family's ``state_dict``
and tells the families apart by their keys (``layout_of``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from pathtracker_torch.models.registry import RECURRENT_ZOO, SLOWFAST, VIDEO_RESNETS

_EXPORT_RULES = [
    (re.compile(r"^preproc_kernel$"), lambda m: "preproc.weight"),
    (re.compile(r"^preproc_bias$"), lambda m: "preproc.bias"),
    (re.compile(r"^conv0_kernel$"), lambda m: "conv0.weight"),
    (re.compile(r"^conv0_bias$"), lambda m: "conv0.bias"),
    (re.compile(r"^conv6_kernel$"), lambda m: "conv6.weight"),
    (re.compile(r"^conv6_bias$"), lambda m: "conv6.bias"),
    (re.compile(r"^bn_scale$"), lambda m: "bn.weight"),
    (re.compile(r"^bn_bias$"), lambda m: "bn.bias"),
    # ClockHGRU's preproc BN and clock rate, FC's dense readout: no rule of
    # the JAX package's export covers them (its export raises on them).
    (re.compile(r"^preproc_bn_scale$"), lambda m: "preproc_bn.weight"),
    (re.compile(r"^preproc_bn_bias$"), lambda m: "preproc_bn.bias"),
    (re.compile(r"^clock_rate$"), lambda m: "clock_rate"),
    (re.compile(r"^readout_(kernel|bias)$"),
     lambda m: "readout." + ("weight" if m.group(1) == "kernel" else "bias")),
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
        elif key == "target_conv.weight" and arr.ndim == 2:
            arr = arr.T[:, :, None, None]  # hgru_v2's 1x1 [C+2,1] -> [1,C+2,1,1]
        elif key in ("readout_dense.weight", "readout.weight"):
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
    (re.compile(r"^preproc_bn\.weight$"), lambda m: "preproc_bn_scale"),
    (re.compile(r"^clock_rate$"), lambda m: "clock_rate"),
    (re.compile(r"^unit1\.(w_inh|w_exc|alpha|mu|gamma|kappa|w)$"), lambda m: m.group(1)),
    (re.compile(r"^(?:unit1\.)?([A-Za-z_0-9]+)\.weight$"), lambda m: f"{m.group(1)}_kernel"),
    (re.compile(r"^(?:unit1\.)?([A-Za-z_0-9]+)\.bias$"), lambda m: f"{m.group(1)}_bias"),
]


def _jax_entry(key: str, value) -> tuple[str, np.ndarray]:
    """One state_dict entry -> (JAX name, f32 numpy array in the JAX layout)."""
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
    elif arr.ndim == 2:
        arr = arr.T  # Linear [out,in] -> [in,out]
    elif arr.ndim == 4 and arr.shape[2:] == (1, 1):
        arr = arr[:, :, 0, 0].T  # [O,I,1,1] conv -> [I,O] matmul
    elif arr.ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif arr.ndim == 3 and arr.shape[1:] == (1, 1):
        arr = arr[:, 0, 0]  # [C,1,1] -> [C]
    return name, np.ascontiguousarray(arr)


def to_jax_params(state_dict: dict) -> dict:
    """The port's ``state_dict`` (or tensors keyed like it, such as
    gradients) -> JAX params {name: f32 numpy array}, flat or nested as the
    JAX module keeps them, in the JAX names and layouts: the inverse of
    ``state_dict_from_jax``."""
    layout = layout_of(state_dict)
    if layout == "tsm":
        return import_tsm_resnet_state_dict(state_dict)
    if layout in ("moe", "pipeline"):
        return {k: _stage_layout(v.detach().to("cpu", torch.float32).numpy(), k, layout, False)
                for k, v in state_dict.items()}
    if layout in _RULE_LAYOUTS:
        return _to_jax_by_rules(state_dict, _rules(layout, state_dict))
    return dict(_jax_entry(key, value) for key, value in state_dict.items())


# --- reference torch checkpoints onto a JAX-layout template ------------------

# FFhGRU's wrapper-level BatchNorm3d (reference ffhgru_hierarchy.py:186) is
# defined and never called; its keys have no counterpart and are dropped.
_UNUSED_REFERENCE_KEYS = re.compile(r"^bn\.(weight|bias)$")
_BN_STATS = re.compile(r"\.(running_mean|running_var|num_batches_tracked)$")


def looks_like_torch_state_dict(params) -> bool:
    """Reference state_dicts use dotted module paths; JAX params do not."""
    return isinstance(params, dict) and any(
        isinstance(k, str) and "." in k for k in params)


def looks_like_slowfast_state_dict(state_dict) -> bool:
    return isinstance(state_dict, dict) and any(
        isinstance(k, str) and "pathway" in k.split("module.")[-1]
        for k in state_dict)


def _fill(template: dict, entries, what: str, strict: bool,
          head_prefixes: tuple = ()) -> dict:
    """Copy ``template`` (dict structure only) and fill it from ``entries``,
    (state_dict key, path into the template or None, JAX-layout array), as
    pathtracker_tpu/train/torch_import.py::_import_by_paths does: a key with
    no path, or a path the template lacks, raises; so does a shape that
    differs from the template's, except under a head (``head_prefixes``: a
    1000-class ImageNet fc on a 1-unit head is skipped, as the reference
    replaced heads after loading); under ``strict`` every non-head template
    parameter must be filled."""
    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v for k, v in tree.items()}

    out, filled, unmapped = copy(template), set(), []
    for key, path, arr in entries:
        node, tnode = out, template
        for part in (path or ())[:-1]:
            if not isinstance(tnode, dict) or part not in tnode:
                path = None
                break
            node, tnode = node[part], tnode[part]
        if not path or not isinstance(tnode, dict) or path[-1] not in tnode:
            unmapped.append(key)
            continue
        shape = tuple(np.shape(tnode[path[-1]]))
        if arr.shape != shape:
            if path[0].startswith(head_prefixes):
                continue
            raise ValueError(f"cannot map {key} of shape {arr.shape} onto "
                             f"parameter {'/'.join(path)} of shape {shape}")
        node[path[-1]] = arr
        filled.add("/".join(path))
    if unmapped:
        raise ValueError(f"{what} checkpoint contains keys with no counterpart "
                         f"here: {sorted(unmapped)}")
    if strict:
        def missing(tree, prefix):
            for k, v in tree.items():
                p = f"{prefix}/{k}" if prefix else k
                if isinstance(v, dict):
                    yield from missing(v, p)
                elif p not in filled and not p.startswith(head_prefixes):
                    yield p
        absent = sorted(missing(template, ""))
        if absent:
            raise ValueError(f"{what} checkpoint is missing parameters: {absent} "
                             "(pass strict=False to keep the template's values)")
    return out


def _strip(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def import_reference_state_dict(state_dict: dict, template: dict,
                                strict: bool = True) -> dict:
    """A reference InT-family torch ``state_dict`` (DataParallel's
    ``module.`` prefix stripped) onto ``template``, flat JAX params: the
    port's modules are the reference layout, so this is ``to_jax_params``
    key by key, checked against the template as
    pathtracker_tpu/train/torch_import.py:113-152 does."""
    def entries():
        for key, value in state_dict.items():
            key = _strip(key)
            try:
                name, arr = _jax_entry(key, torch.as_tensor(value))
            except ValueError:
                name, arr = None, None
            if (name is None or name not in template) and _UNUSED_REFERENCE_KEYS.match(key):
                continue
            yield key, (name,) if name else None, arr

    return _fill(template, entries(), "torch", strict)


def jax_leaves(tree: dict, prefix: str = ""):
    """(path, leaf) of a JAX params tree in the order jax.tree_util flattens
    it (sorted keys), the path as ``jax.tree_util.keystr`` writes it:
    ``['layer1_0']['conv1']['kernel']``."""
    for key in sorted(tree):
        path = f"{prefix}[{key!r}]"
        if isinstance(tree[key], dict):
            yield from jax_leaves(tree[key], path)
        else:
            yield path, tree[key]


def _stage_layout(arr: np.ndarray, key: str, layout: str, to_port: bool) -> np.ndarray:
    """A pipeline's stacked conv kernel [S, kh, kw, I, O] <-> [S, O, I, kh,
    kw]; every other leaf of the parallel modes as it is."""
    if layout == "pipeline" and key == "k":
        arr = arr.transpose(0, 4, 3, 1, 2) if to_port else arr.transpose(0, 3, 4, 2, 1)
    return np.ascontiguousarray(arr)


# model name -> its parameters' layout; every other name is "flat"
LAYOUTS = {"rntsm": "tsm", **dict.fromkeys(RECURRENT_ZOO, "zoo"),
           **dict.fromkeys(VIDEO_RESNETS, "video_resnet"),
           **dict.fromkeys(SLOWFAST, "slowfast"), "timesformer": "transformer",
           "performer": "performer", "lambda": "lambda"}
# the layouts that rule tables map, in the order layout_of tries them
_RULE_LAYOUTS = ("video_resnet", "zoo", "slowfast", "transformer", "performer", "lambda")


_MOE_KEYS = frozenset({"router_w", "w1", "b1", "w2", "b2"})
_PIPELINE_KEYS = frozenset({"k", "b"})


def layout_of(state_dict) -> str:
    """The layout of a port ``state_dict`` (or of tensors keyed like one),
    from its keys: "tsm", "moe", "pipeline", one of ``_RULE_LAYOUTS`` or
    "flat"."""
    if looks_like_tsm_resnet_state_dict(state_dict):
        return "tsm"
    if set(state_dict) == _MOE_KEYS:
        return "moe"
    if set(state_dict) == _PIPELINE_KEYS:
        return "pipeline"
    for layout in _RULE_LAYOUTS:
        rules = _rules(layout, state_dict)
        if state_dict and all(_match(rules, key, 1) for key in state_dict):
            return layout
    return "flat"


def state_dict_from_jax(model: str, params: dict) -> dict:
    """JAX params -> the port's ``state_dict``, by the mapping of ``model``:
    a model name, or a layout name of ``layout_of``."""
    layout = LAYOUTS.get(model, model)
    if layout == "tsm":
        return export_tsm_resnet_state_dict(params)
    if layout in ("moe", "pipeline"):
        return {k: torch.tensor(_stage_layout(np.asarray(v, np.float32), k, layout, True))
                for k, v in params.items()}
    if layout in _RULE_LAYOUTS:
        return _from_jax_by_rules(params, _rules(layout, params))
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
    # fc: a plain torchvision ResNet's Linear head
    (re.compile(r"^fc1?\.weight$"), lambda m: ("fc1_kernel",)),
    (re.compile(r"^fc1?\.bias$"), lambda m: ("fc1_bias",)),
]
_BN_LEAF = {"weight": "bn_scale", "bias": "bn_bias"}


def _tsm_entry(key: str, value) -> tuple[tuple | None, np.ndarray]:
    """One resnet_TSM / torchvision ResNet entry -> (path in the nested JAX
    tree or None, f32 numpy array in the JAX layout)."""
    arr = torch.as_tensor(value).detach().to("cpu", torch.float32).numpy()
    path = None
    for pattern, fn in _TSM_IMPORT_RULES:
        m = pattern.match(key)
        if m:
            path = fn(m)
            path = path[:-1] + (_BN_LEAF.get(path[-1], path[-1]),)
            break
    if arr.ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif arr.ndim == 3:
        arr = arr[..., 0].T  # Conv1d head [cls,C,1] -> [C,cls]
    elif arr.ndim == 2:
        arr = arr.T  # Linear head [cls,C] -> [C,cls]
    return path, np.ascontiguousarray(arr)


def import_tsm_resnet_state_dict(state_dict: dict, template: dict | None = None,
                                 strict: bool = True) -> dict:
    """A TSMResNet ``state_dict`` (the port's, the reference resnet_TSM's, or
    tensors keyed like them) -> the nested JAX tree of f32 numpy arrays: the
    inverse of ``export_tsm_resnet_state_dict``.

    With ``template`` (a nested JAX tree), as
    pathtracker_tpu/train/torch_import.py::import_tsm_resnet_state_dict:
    ``module.`` stripped, BN running statistics dropped (the norms use batch
    statistics), a plain torchvision ResNet's ``fc`` that does not fit the
    head skipped; use ``strict=False`` for ImageNet trunks, which lack the
    MotionSqueeze and the head."""
    if template is not None:
        entries = ((key, *_tsm_entry(key, value))
                   for key, value in ((_strip(k), v) for k, v in state_dict.items())
                   if not _BN_STATS.search(key))
        return _fill(template, entries, "TSM/resnet", strict, head_prefixes=("fc1_",))
    out = {}
    for key, value in state_dict.items():
        path, arr = _tsm_entry(key, value)
        if path is None:
            raise ValueError(f"no TSMResNet counterpart for state_dict key {key!r}")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return out


# --- the rest of the zoo and the video ResNets: rule tables -----------------
#
# (JAX path, state_dict key, layout). A ``{field}`` matches letters and
# digits (no '_', '.' or '/') and carries over to the other side; the first
# rule that matches wins, in either direction. Layouts: None (the same
# array), "conv" (kernel spatial dims + [I, O] <-> [O, I] + spatial dims),
# "linear" ([in, out] <-> [out, in]) and "hwc" ([H, W, C] <-> [C, H, W]).

_CELL = "SpatioTemporalLSTMCell_0"  # flax's name for stlstm's shared cell
_ZOO_RULES = [
    ("conv7_kernel", "conv7.weight", "linear"),  # ffnet's 1x1x1 conv to 2 channels
    ("conv{i}_kernel", "conv{i}.weight", "conv"),
    ("conv{i}_bias", "conv{i}.bias", None),
    ("bn{i}_scale", "bn{i}.weight", None),
    ("bn{i}_bias", "bn{i}.bias", None),
    ("bn_scale", "bn.weight", None),
    ("bn_bias", "bn.bias", None),
    ("fc{i}_kernel", "fc{i}.weight", "linear"),
    ("fc{i}_bias", "fc{i}.bias", None),
    # ops/lstm.py: JAX <name>_l<k>[_rev]_{w,b}_{ih,hh} <-> nn.LSTM's tensors
    ("{m}_l{k}_w_{g}", "{m}.weight_{g}_l{k}", "linear"),
    ("{m}_l{k}_rev_w_{g}", "{m}.weight_{g}_l{k}_reverse", "linear"),
    ("{m}_l{k}_b_{g}", "{m}.bias_{g}_l{k}", None),
    ("{m}_l{k}_rev_b_{g}", "{m}.bias_{g}_l{k}_reverse", None),
    (f"{_CELL}/conv_last_kernel", "unit1.conv_last.weight", "linear"),
    (f"{_CELL}/conv_last_bias", "unit1.conv_last.bias", None),
    (_CELL + "/conv_{g}_kernel", "unit1.conv_{g}.0.weight", "conv"),
    (_CELL + "/conv_{g}_bias", "unit1.conv_{g}.0.bias", None),
    (_CELL + "/conv_{g}_ln_scale", "unit1.conv_{g}.1.weight", "hwc"),
    (_CELL + "/conv_{g}_ln_bias", "unit1.conv_{g}.1.bias", "hwc"),
]


def _bn_rules(jax_prefix: str, torch_prefix: str) -> list:
    return [(f"{jax_prefix}_scale", f"{torch_prefix}.weight", None),
            (f"{jax_prefix}_bias", f"{torch_prefix}.bias", None)]


def _video_resnet_rules(r2plus1: bool) -> list:
    """pathtracker_tpu/train/torch_import.py:234-312's names, both ways."""
    if r2plus1:
        stem = [("stem_s/kernel", "stem.0.weight", "conv"), *_bn_rules("stem_s/bn", "stem.1"),
                ("stem_t/kernel", "stem.3.weight", "conv"), *_bn_rules("stem_t/bn", "stem.4")]
    else:
        stem = [("stem/kernel", "stem.0.weight", "conv"), *_bn_rules("stem/bn", "stem.1")]
    blk, tv = "layer{l}_{b}", "layer{l}.{b}"
    return stem + [
        (blk + "/conv{c}/kernel", tv + ".conv{c}.0.weight", "conv"),
        (blk + "/conv{c}/kernel_s", tv + ".conv{c}.0.0.weight", "conv"),
        *_bn_rules(blk + "/conv{c}/bn", tv + ".conv{c}.0.1"),
        (blk + "/conv{c}/kernel_t", tv + ".conv{c}.0.3.weight", "conv"),
        *_bn_rules(blk + "/bn{c}", tv + ".conv{c}.1"),
        (blk + "/ds_kernel", tv + ".downsample.0.weight", "conv"),
        *_bn_rules(blk + "/ds_bn", tv + ".downsample.1"),
        ("fc_kernel", "fc.weight", "linear"),
        ("fc_bias", "fc.bias", None),
        ("target_conv_kernel", "target_conv.weight", "conv"),
        ("target_conv_bias", "target_conv.bias", None),
    ]


def _convbn_rules(jax_prefix: str, conv_key: str, bn_prefix: str) -> list:
    return [(f"{jax_prefix}/kernel", conv_key, "conv"),
            *_bn_rules(f"{jax_prefix}/bn", bn_prefix)]


def _slowfast_rules(two_pathways: bool) -> list:
    """FAIR pyslowfast's names (the port's) <-> models/slowfast.py's nested
    tree, for SlowFast or, with ``two_pathways`` False, SlowOnly."""
    rules = []
    for jax, p in ((("slow_", "0"), ("fast_", "1")) if two_pathways else (("", "0"),)):
        fair = "s1.pathway" + p + "_stem"
        rules += _convbn_rules(jax + "stem", fair + ".conv.weight", fair + ".bn")
        blk, res = jax + "res{s}_{b}", "s{s}.pathway" + p + "_res{b}"
        rules += _convbn_rules(blk + "/proj", res + ".branch1.weight", res + ".branch1_bn")
        rules += _convbn_rules(blk + "/{c}", res + ".branch2.{c}.weight", res + ".branch2.{c}_bn")
    if two_pathways:
        for j in range(1, 5):
            fair = f"s{j}_fuse"
            rules += _convbn_rules(f"fuse{j - 1}", fair + ".conv_f2s.weight", fair + ".bn")
    nl = "s{s}.pathway0_nonlocal{b}"
    rules += [("nl_res{s}_{b}/{m}/kernel", nl + ".conv_{m}.weight", "conv"),
              *_bn_rules("nl_res{s}_{b}/out/bn", nl + ".bn"),
              ("head_kernel", "head.projection.weight", "linear"),
              ("head_bias", "head.projection.bias", None)]
    return rules


def _linear_rules(jax_prefix: str, torch_prefix: str, bias: bool = True) -> list:
    return [(f"{jax_prefix}_kernel", f"{torch_prefix}.weight", "linear")] + (
        [(f"{jax_prefix}_bias", f"{torch_prefix}.bias", None)] if bias else [])


def _ln_rules(prefix: str = "") -> list:
    """LayerNorms ``ln_<name>`` (under ``prefix``, a JAX path)."""
    tp = prefix.replace("/", ".")
    return [(f"{prefix}ln_{{n}}_scale", f"{tp}ln_{{n}}.weight", None),
            (f"{prefix}ln_{{n}}_bias", f"{tp}ln_{{n}}.bias", None)]


def _attention_rules(jax_mod: str, torch_mod: str) -> list:
    """models/transformers.py's _MHA and _MLP modules named ``jax_mod``."""
    return [(f"{jax_mod}/qkv_kernel", f"{torch_mod}.qkv.weight", "linear"),
            *_linear_rules(f"{jax_mod}/out", f"{torch_mod}.out"),
            *_linear_rules(f"{jax_mod}/fc{{j}}", f"{torch_mod}.fc{{j}}")]


_READOUT_RULES = [("target_conv_kernel", "target_conv.weight", "conv"),
                  ("target_conv_bias", "target_conv.bias", None),
                  *_linear_rules("readout_dense", "readout_dense"),
                  *_linear_rules("preproc", "preproc")]

_TRANSFORMER_RULES = [  # the TimeSformer and the ViT
    *_linear_rules("patch", "patch"), ("pos_emb", "pos_emb", None),
    ("cls_token", "cls_token", None), *_linear_rules("head", "head"),
    *_ln_rules(), *_ln_rules("encoder/"),
    *_attention_rules("{a}_attn{i}", "{a}_attn{i}"),  # time_attn0, space_attn0
    *_attention_rules("mlp{i}", "mlp{i}"), *_attention_rules("mlp_cls{i}", "mlp_cls{i}"),
    *_attention_rules("encoder/attn{i}", "encoder.attn{i}"),
    *_attention_rules("encoder/mlp{i}", "encoder.mlp{i}"),
]
_PERFORMER_RULES = [
    ("favor_proj", "favor_proj", None), *_ln_rules(), *_READOUT_RULES,
    ("attn{i}_qkv", "attn{i}.qkv.weight", "linear"),
    ("attn{i}_out", "attn{i}.out.weight", "linear"),
    *_attention_rules("ff{i}", "ff{i}"),
]
_LAMBDA_RULES = [
    ("to_{x}_kernel", "to_{x}.weight", "linear"), ("pos_emb", "pos_emb", None),
    ("bn_{x}_scale", "bn_{x}.weight", None), ("bn_{x}_bias", "bn_{x}.bias", None),
    *_READOUT_RULES,
]


def _compile(rules: list) -> list:
    """Each rule as (JAX regex, state_dict regex, JAX format, state_dict
    format, layout)."""
    def regex(fmt):
        return re.compile(re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[A-Za-z0-9]+)", re.escape(fmt)))

    return [(regex(j), regex(t), j, t, layout) for j, t, layout in rules]


_ZOO = _compile(_ZOO_RULES)
_VIDEO = {r2plus1: _compile(_video_resnet_rules(r2plus1)) for r2plus1 in (False, True)}
_SLOWFAST = {two: _compile(_slowfast_rules(two)) for two in (False, True)}
_TABLES = {"zoo": _ZOO, "transformer": _compile(_TRANSFORMER_RULES),
           "performer": _compile(_PERFORMER_RULES), "lambda": _compile(_LAMBDA_RULES)}


def _rules(layout: str, tree) -> list:
    """The compiled rules of ``layout`` (one of ``_RULE_LAYOUTS``) for a JAX
    tree or a state_dict (which tells (2+1)D's stem from the other video
    ResNets', and SlowFast's two pathways from ``slow``'s one)."""
    if layout == "video_resnet":
        return _VIDEO["stem.3.weight" in tree or "stem_s" in tree]
    if layout == "slowfast":
        return _SLOWFAST[any(k in tree for k in ("slow_stem", "fast_stem",
                                                  "s1.pathway1_stem.conv.weight"))]
    return _TABLES[layout]


def _match(rules, name: str, side: int):
    """(the other side's name, layout) of the first rule whose ``side``
    (0: JAX path, 1: state_dict key) matches ``name``, or None."""
    for rule in rules:
        m = rule[side].fullmatch(name)
        if m:
            return rule[3 - side].format(**m.groupdict()), rule[4]
    return None


# A conv kernel moves between [O, I, *k] and [*k, I, O] in two copies, a 2-D
# transpose and a swap of whole rows of O: ~3x faster than numpy's one
# 5-D copy (r3d's checkpoint, weights and Adam's moments, ~4 s -> ~1.4 s).

def _to_jax_layout(arr: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        o, i, *k = arr.shape
        rows = np.ascontiguousarray(arr.reshape(o, -1).T).reshape(i, -1, o)
        return np.ascontiguousarray(rows.transpose(1, 0, 2)).reshape(*k, i, o)
    if layout == "linear":
        arr = arr.T
    elif layout == "hwc":
        arr = arr.transpose(1, 2, 0)
    return np.ascontiguousarray(arr)


def _from_jax_layout(arr: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        *k, i, o = arr.shape
        rows = np.ascontiguousarray(arr.reshape(-1, i, o).transpose(1, 0, 2))
        return np.ascontiguousarray(rows.reshape(-1, o).T).reshape(o, i, *k)
    if layout == "linear":
        arr = arr.T
    elif layout == "hwc":
        arr = arr.transpose(2, 0, 1)
    return np.ascontiguousarray(arr)


def _flat_paths(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _flat_paths(value, path)
        else:
            yield path, value


def _from_jax_by_rules(params: dict, rules) -> dict:
    out = {}
    for path, value in _flat_paths(params):
        hit = _match(rules, path, 0)
        if hit is None:
            raise ValueError(f"no port counterpart for JAX parameter {path!r}")
        key, layout = hit
        # a copy: checkpoint arrays are read-only
        out[key] = torch.tensor(_from_jax_layout(np.asarray(value, np.float32), layout))
    return out


def _jax_rule_entry(rules, key: str, value):
    """(JAX path tuple or None, f32 array in the JAX layout) of one entry."""
    arr = torch.as_tensor(value).detach().to("cpu", torch.float32).numpy()
    hit = _match(rules, key, 1)
    if hit is None:
        return None, arr
    path, layout = hit
    return tuple(path.split("/")), _to_jax_layout(arr, layout)


def _to_jax_by_rules(state_dict: dict, rules) -> dict:
    out = {}
    for key, value in state_dict.items():
        path, arr = _jax_rule_entry(rules, key, value)
        if path is None:
            raise ValueError(f"no JAX counterpart for state_dict key {key!r}")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return out


def looks_like_video_resnet_state_dict(state_dict) -> bool:
    """torchvision's video ResNets (and the reference's forks of them) name
    their stem ``stem.*`` and their stages ``layerL.B.convI.*``."""
    return any(isinstance(k, str) and _strip(k).startswith(("stem.", "layer1."))
               for k in state_dict)


def import_video_resnet_state_dict(state_dict: dict, template: dict,
                                   strict: bool = True) -> dict:
    """A torchvision-layout video-ResNet ``state_dict`` (r3d_18, mc3_18,
    r2plus1d_18, or the reference's forks of them) onto ``template``, the
    nested JAX tree of models/video_resnet.py, as
    pathtracker_tpu/train/torch_import.py::import_video_resnet_state_dict
    does: ``module.`` stripped, BN running statistics dropped (the norms use
    batch statistics), a Kinetics 400-class ``fc`` that does not fit the
    1-unit head skipped (the reference replaced the head after loading,
    reference utils/engine.py:188-190)."""
    rules = _rules("video_resnet", {_strip(k): None for k in state_dict})
    entries = ((key, *_jax_rule_entry(rules, key, value))
               for key, value in ((_strip(k), v) for k, v in state_dict.items())
               if not _BN_STATS.search(key))
    return _fill(template, entries, "torchvision", strict, head_prefixes=("fc_",))


# --- SlowFast: FAIR pyslowfast checkpoints ----------------------------------

def import_slowfast_state_dict(state_dict: dict, template: dict,
                               strict: bool = True) -> dict:
    """A FAIR pyslowfast ``state_dict`` (the reference's slowfast /
    slowfast_nl checkpoints) onto ``template``, the nested JAX tree of
    models/slowfast.py, as
    pathtracker_tpu/train/torch_import.py::import_slowfast_state_dict does:
    ``module.`` stripped, conv weights OITHW -> THWIO, the head
    [classes, feat] -> [feat, classes] (slow features before fast, as FAIR's
    head concatenates them), BN running statistics dropped (the norms use
    batch statistics), a Kinetics 400-class head that does not fit the
    1-unit head skipped."""
    rules = _rules("slowfast", template)
    entries = ((key, *_jax_rule_entry(rules, key, value))
               for key, value in ((_strip(k), v) for k, v in state_dict.items())
               if not _BN_STATS.search(key))
    return _fill(template, entries, "slowfast", strict, head_prefixes=("head_",))


def export_slowfast_state_dict(params: dict) -> dict:
    """models/slowfast.py params (JAX names and layouts) -> a FAIR
    pyslowfast ``state_dict``, which is the port's."""
    return _from_jax_by_rules(params, _rules("slowfast", params))
