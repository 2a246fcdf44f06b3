"""The port's checkpoint reader and serving path against pathtracker_tpu:
the pure-Python msgpack reader against flax on the in-tree checkpoints, and
make_inference_fn on the trained chainE weights against the JAX serving
function with --bf16 semantics."""

import glob
import os
import types

import numpy as np
import pytest
import torch
from flax import serialization

from pathtracker_torch import engine as tengine
from pathtracker_torch.data.pathtracker import render_batch
from pathtracker_torch.eval import serve as tserve
from pathtracker_torch.models import registry as tregistry
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_tpu.eval import serve as jserve
from pathtracker_tpu.train.checkpoint import load_params as jload_params
from pathtracker_tpu.train.loop import init_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVED = os.path.join(ROOT, "results_conv", "64_1_14", "chainE", "saved_models")
CHAINE = os.path.join(SAVED, "model_val_acc_0072_epoch_15_checkpoint.pth.tar")


def _assert_same_tree(ours, theirs, path="root"):
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), path
        for k in theirs:
            _assert_same_tree(ours[k], theirs[k], f"{path}/{k}")
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        np.testing.assert_array_equal(ours, theirs, err_msg=path)
    else:
        assert type(ours) is type(theirs) and ours == theirs, path


@pytest.mark.parametrize("name", sorted(os.path.basename(p) for p in
                                        glob.glob(os.path.join(SAVED, "*.tar"))))
def test_msgpack_reader_matches_flax(name):
    with open(os.path.join(SAVED, name), "rb") as f:
        blob = f.read()
    _assert_same_tree(tckpt.unpackb(blob), serialization.msgpack_restore(blob))


def test_msgpack_reader_scalars_and_errors():
    import msgpack

    value = {"i": [0, 127, 128, 65536, 2 ** 40, -1, -33, -2 ** 40], "f": 1.5,
             "s": "x" * 40, "b": b"\x00\x01", "n": None, "t": True, "F": False,
             "m": {str(i): i for i in range(20)}, "l": list(range(20))}
    assert tckpt.unpackb(msgpack.packb(value, use_bin_type=True)) == value
    with pytest.raises(ValueError, match="trailing"):
        tckpt.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        tckpt.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(ValueError, match="ext type 5"):
        tckpt.unpackb(msgpack.packb(msgpack.ExtType(5, b"zz")))


def test_chaine_weights_load_strictly():
    params = tckpt.load_params(CHAINE)
    assert set(params) == set(jload_params(CHAINE))
    model = tserve.build(ckpt=CHAINE, length=4, bf16=True, device="cpu")
    assert model.use_fused and model.dimensions == 32
    got = model.state_dict()["unit1.w_exc"].numpy()
    np.testing.assert_array_equal(got, params["w_exc"].transpose(3, 2, 0, 1))


def test_serving_chaine_matches_jax_bf16():
    """B=2, T=8 clips rendered from a seed as chainE was trained (dist 14,
    speed 1, 2-pixel dots). JAX --bf16 serves the eager mixed cell (its
    fused default is off); the port serves the fused cell (plain kernel
    versions here). Gap: bf16 roundings of the conv outputs flip where XLA
    and oneDNN sum in other orders, and the trained recurrence carries the
    flips on; at these inputs (``python tests/torch_parity_gaps.py
    --length 8 --batch 2``) port-fused vs JAX-eager measured 4.3e-5 on
    logits, port-eager vs JAX-eager 1.3e-3 and JAX's own fused vs eager
    3.1e-4. Held to 5e-3 on logits (2e-3 on scores), where an equation
    error moves them by O(0.1)."""
    length = 8
    x, _ = render_batch(0, 2, timesteps=length, dot_size=2)
    margs = types.SimpleNamespace(model="InT", seed=0, dimensions=32,
                                  fb_kernel_size=7, algo="bptt", penalty=False,
                                  optical_flow=False, pretrained=False,
                                  slowfast_cfg=None, bf16=True)
    jmodel, variables = init_model(margs, length)
    jparams = jload_params(CHAINE, template=variables["params"])
    want = np.asarray(jserve.make_inference_fn(jmodel, "InT", jparams)(x))
    want_logit = np.asarray(jserve.make_inference_fn(jmodel, "InT", jparams,
                                                     probs=False)(x))

    model = tserve.build(ckpt=CHAINE, length=length, bf16=True, device="cpu")
    got = tserve.make_inference_fn(model, "InT")(x)
    got_logit = tserve.make_inference_fn(model, "InT", probs=False)(torch.from_numpy(x))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got_logit.numpy(), want_logit, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_torch_pickle_checkpoints_wait_for_training(tmp_path):
    """The training slice reads the reference's torch pickles, with
    weights_only=True; a serving model built from one needs the template
    of engine.load_ckpt (tests/test_torch_checkpoint.py)."""
    path = tmp_path / "ref.pth.tar"
    torch.save({"state_dict": {"unit1.w": torch.ones(2, 1, 1)}}, path)
    state = tckpt.load_checkpoint(str(path))
    assert set(state) == {"state_dict"} and torch.equal(
        state["state_dict"]["unit1.w"], torch.ones(2, 1, 1))
    with pytest.raises(ValueError, match="template"):
        tckpt.load_params(str(path))


def test_registry_and_engine_surface():
    assert tregistry.family("InT") == "recurrent"
    assert tregistry.family("r3d") == "torchvision"
    assert tregistry.needs_coord_channels("nostride_r3d_cc")
    assert not tregistry.needs_coord_channels("nostride_video_cc_small")
    for name in ("InT_no_inh", "InT_tanh", "InT_only_add"):
        m = tregistry.model_selector(name, timesteps=2, fb_kernel_size=3,
                                     dimensions=8, device="cpu")
        assert not m.use_fused
    for name in ("stlstm", "lrcn", "r3d"):
        assert tregistry.model_selector(name, timesteps=8, device="cpu").training
    assert tregistry.family("slowfast") == "slowfast" and tregistry.family("slow") == "torchvision"
    x = torch.zeros(2, 3, 4, 8, 8)
    for name in ("slowfast", "slowfast_nl", "slow", "timesformer", "performer", "lambda"):
        extra = (dict(width=8, stage_blocks=(1, 1)) if name.startswith("slow") else
                 dict(patch_size=4, height=8, width=8) if name == "timesformer" else
                 dict(height=8, width=8) if name == "lambda" else {})
        m = tregistry.model_selector(name, timesteps=4, device="cpu", **extra)
        scores = tserve.make_inference_fn(m, name)(np.zeros((2, 4, 8, 8, 3), np.uint8))
        assert scores.shape == (2,) and bool(((scores >= 0) & (scores <= 1)).all())
        with torch.no_grad():
            out, states, gates = tengine.model_step(m, x, name, test=True)
        assert out.shape == (2, 1) and states is None and gates is None
    with pytest.raises(NotImplementedError, match="Model not found"):
        tregistry.model_selector("nope", timesteps=2, device="cpu")
    args = types.SimpleNamespace(model="InT", bf16=True, dimensions=8,
                                 fb_kernel_size=3)
    m = tengine.model_selector(args, 2, device="cpu")
    assert m.mxu == torch.bfloat16 and m.use_fused is False  # 8 channels
    rbp = tengine.model_selector(types.SimpleNamespace(model="InT", algo="rbp"), 2,
                                 device="cpu")
    assert rbp.grad_method == "rbp" and not rbp.use_fused
    x = torch.zeros(1, 3, 2, 4, 4)
    with torch.no_grad():
        logit, states, gates = tengine.model_step(m, x, "InT", test=True)
    assert states.shape == (1, 2, 1, 4, 4) and gates.shape == (1, 2, 8, 4, 4)


def test_engine_algo_as_jax():
    """--algo matters in the recurrent family only: InT builds under 'bptt',
    'Testing' (what the eval scripts set) and 'rbp'; rntsm ignores it; the
    other recurrent models refuse 'rbp'. The JAX package does the same."""
    from pathtracker_tpu import engine as jengine

    def args(model, algo):
        return types.SimpleNamespace(model=model, algo=algo, dimensions=8,
                                     fb_kernel_size=3)

    for model, algo in (("InT", "bptt"), ("InT", "Testing"), ("rntsm", "rbp")):
        jengine.model_selector(args(model, algo), 2)
        m = tengine.model_selector(args(model, algo), 2, device="cpu")
        assert isinstance(m, torch.nn.Module), (model, algo)
    jengine.model_selector(args("InT", "rbp"), 2)
    assert tengine.model_selector(args("InT", "rbp"), 2, device="cpu").grad_method == "rbp"
    for model in ("hgru", "gru"):
        with pytest.raises(NotImplementedError, match="InT"):
            jengine.model_selector(args(model, "rbp"), 2)
        with pytest.raises(NotImplementedError, match="InT"):
            tengine.model_selector(args(model, "rbp"), 2, device="cpu")
