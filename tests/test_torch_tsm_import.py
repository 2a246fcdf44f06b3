"""Carrying ``rntsm`` weights between the packages: the JAX nested tree to the
port's state_dict (strict load) and back, the dispatch by family, and a
checkpoint written by pathtracker_tpu.train.checkpoint read by the port's
msgpack reader and ``serve.build``. All exact: the mapping only renames and
transposes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.eval import serve as tserve
from pathtracker_torch.models import tsm_resnet as T
from pathtracker_torch.train import checkpoint as tckpt
from pathtracker_torch.train import torch_import as TI
from pathtracker_tpu.models import tsm_resnet as J
from pathtracker_tpu.train import torch_import as JI
from pathtracker_tpu.train.checkpoint import save_checkpoint


def _numpy_params(model, seed=0, clip=(1, 3, 2, 8, 8)):
    """A parameter tree of the JAX model's names and shapes (``eval_shape``:
    nothing is compiled) filled with seeded numpy values."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.key(0), a),
                            jax.ShapeDtypeStruct(clip, jnp.float32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(b, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == np.float32 and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("block,flow", [("bottleneck", True), ("basic", True),
                                        ("bottleneck", False)])
def test_jax_params_load_strictly_and_round_trip(block, flow):
    kwargs = dict(layers=(1, 2, 1, 1), block=block, flow_estimation=flow)
    params = _numpy_params(J.TSMResNet(**kwargs))
    state = TI.export_tsm_resnet_state_dict(params)
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in state.values())
    model = T.TSMResNet(device="cpu", **kwargs)
    model.load_state_dict(state, strict=True)
    assert TI.looks_like_tsm_resnet_state_dict(state)
    _assert_trees_equal(TI.to_jax_params(model.state_dict()), params)
    _assert_trees_equal(TI.import_tsm_resnet_state_dict(state), params)


def test_mapping_is_the_jax_packages_own():
    """Key for key and value for value the state_dict that
    pathtracker_tpu.train.torch_import exports, and its importer inverts the
    port's export."""
    model = J.TSMResNet(layers=(1, 1, 1, 1))
    params = _numpy_params(model, seed=1)
    ours = TI.export_tsm_resnet_state_dict(params)
    theirs = JI.export_tsm_resnet_state_dict(params)
    assert set(ours) == set(theirs)
    for k in theirs:
        assert torch.equal(ours[k], theirs[k]), k
    assert JI.looks_like_tsm_resnet_state_dict(ours)
    _assert_trees_equal(JI.import_tsm_resnet_state_dict(ours, params), params)


def test_layouts():
    params = _numpy_params(J.TSMResNet(layers=(1, 1, 1, 1)), seed=2)
    state = TI.export_tsm_resnet_state_dict(params)
    dw = params["flow_refinement"]["dw1"]["kernel"]  # depthwise [k,k,1,C]
    assert dw.shape == (7, 7, 1, 3) and state["flow_refinement.conv1.0.weight"].shape == (3, 1, 7, 7)
    np.testing.assert_array_equal(state["flow_refinement.conv1.0.weight"].numpy(),
                                  dw.transpose(3, 2, 0, 1))
    assert state["conv1.weight"].shape == (64, 3, 7, 7)
    assert state["fc1.weight"].shape == (1, 2048, 1)
    np.testing.assert_array_equal(state["fc1.weight"].numpy()[:, :, 0], params["fc1_kernel"].T)
    np.testing.assert_array_equal(state["layer2.0.downsample.1.bias"].numpy(),
                                  params["layer2_0"]["down"]["bn_bias"])


def test_dispatch_by_family_and_errors():
    params = _numpy_params(J.TSMResNet(layers=(1, 1, 1, 1)), seed=3)
    state = TI.state_dict_from_jax("rntsm", params)  # by model name: the TSM rules
    assert "layer1.0.conv1.weight" in state
    assert list(TI.export_tsm_resnet_state_dict(params)) == list(state)
    flat = {"preproc_kernel": np.zeros((3, 4), np.float32)}
    assert list(TI.state_dict_from_jax("InT", flat)) == ["preproc.weight"]
    assert not TI.looks_like_tsm_resnet_state_dict(TI.export_reference_state_dict(flat))
    grads = {k: torch.zeros_like(v) for k, v in state.items()}  # keyed like a state_dict
    assert set(TI.to_jax_params(grads)) == set(params)
    with pytest.raises(ValueError, match="no resnet_TSM counterpart"):
        TI.export_tsm_resnet_state_dict({**params, "extra": {}})
    with pytest.raises(ValueError, match="unknown block member"):
        TI.export_tsm_resnet_state_dict({**params, "layer1_0": {"conv9x": {}}})
    with pytest.raises(ValueError, match="no TSMResNet counterpart"):
        TI.import_tsm_resnet_state_dict({**state, "layer1.0.se.weight": torch.zeros(1)})


def test_jax_rntsm_checkpoint_loads_through_the_port(tmp_path):
    """The full-width rntsm tree (ResNet-50 layers, 2048-wide head) saved by
    the JAX package's checkpoint writer, read back by the port's msgpack
    reader, and loaded by ``serve.build(model='rntsm')`` with strict=True."""
    from pathtracker_tpu.models.registry import model_selector as jselect

    params = _numpy_params(jselect("rntsm", timesteps=2), seed=4)
    path = str(tmp_path / "model_val_acc_0050_epoch_1_checkpoint.pth.tar")
    save_checkpoint(path, params, epoch=1, acc=50.0)
    loaded = tckpt.load_params(path)
    _assert_trees_equal(loaded, params)
    assert tckpt.load_checkpoint(path)["epoch"] == 1

    model = tserve.build(model="rntsm", ckpt=path, length=2, device="cpu")
    assert isinstance(model, T.TSMResNet) and not model.training
    assert (model.layers, model.patch, model.remat, model.fused) == ((3, 4, 6, 3), 15, False, True)
    _assert_trees_equal(TI.to_jax_params(model.state_dict()), params)
    assert tserve.build(model="rntsm", length=2, device="cpu", remat_blocks=True).remat
    x = np.random.default_rng(5).integers(0, 255, (1, 2, 8, 8, 3), dtype=np.uint8)
    score = tserve.make_inference_fn(model, "rntsm")(x)
    assert score.shape == (1,) and 0.0 <= score.item() <= 1.0
