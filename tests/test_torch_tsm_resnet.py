"""pathtracker_torch.models.tsm_resnet against pathtracker_tpu.models.tsm_resnet
on the same seeded inputs, with the JAX weights carried across: ``_ConvBN``
(grouped too), both block types, ``_FlowRefinement``, ``_match_to_flow_soft``
and the whole ``TSMResNet`` (logits and parameter gradients), and the four
builders' parameter names and shapes. ``remat`` and ``fused=False`` against
the default net are tests/test_torch_tsm_resnet_remat.py's.

Tolerances. Single modules: atol 2e-5 on O(1) outputs (f32 convs and batch
statistics summed in another order by oneDNN and XLA's CPU backend). The
whole net: logits atol 1e-4. Its gradients, each normalised by its largest
entry: every entry within 0.1 and each gradient's mean gap within 2e-2.
The net has some six million ReLU inputs at this size, so in any f32 run one
or two lie within rounding of zero and their masks differ between two f32
implementations (or between f32 and f64 of one); a channel's gradient is a
signed sum over 1152 positions, of which one flipped position is a few
percent, and the parameters upstream of it move by a few 1e-3. Against the
port's own float64 run the port's and the JAX package's f32 gradients both
measure up to 3e-2 in one channel and ~2e-6 downstream of the flip; between
the two packages the four cases measure up to 4.8e-2 (max) and 7.8e-3 (mean;
the 3-entry BN bias of the first flow-refinement conv, which sits behind
the soft-argmax windows).
An equation error moves most entries by O(0.1-1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.models import tsm_resnet as T
from pathtracker_torch.train.torch_import import (export_tsm_resnet_state_dict,
                                                  to_jax_params)
from pathtracker_tpu.models import tsm_resnet as J
from torch_threads import one_thread  # noqa: F401

ATOL = 2e-5


def _randomized(tree, seed):
    """The JAX init with every BN scale and bias redrawn, so that they matter."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "bn_scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        if name in ("bn_bias", "fc1_bias"):
            return jnp.asarray(rng.uniform(-0.5, 0.5, v.shape).astype(np.float32))
        return v

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _load_convbn(conv, bn, jmod):
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(jmod["kernel"]).transpose(3, 2, 0, 1).copy()))
        bn.weight.copy_(torch.tensor(np.asarray(jmod["bn_scale"])))
        bn.bias.copy_(torch.tensor(np.asarray(jmod["bn_bias"])))


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("cin,cout,kernel,groups,relu", [
    (3, 8, 7, 1, True), (6, 6, 3, 6, True), (3, 3, 7, 3, False), (8, 16, 1, 1, False),
    (8, 8, 3, 2, True)])
def test_conv_bn_matches_jax(cin, cout, kernel, groups, relu):
    x = np.random.default_rng(0).standard_normal((3, 6, 5, cin)).astype(np.float32)
    jm = J._ConvBN(cin, cout, kernel, groups=groups, relu=relu)
    params = _randomized(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = T._ConvBN(cin, cout, kernel, groups, relu, gen=_gen())
    assert tm[0].weight.shape == (cout, cin // groups, kernel, kernel)
    _load_convbn(tm[0], tm[1], params)
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)


def test_conv_init_is_kaiming_fan_out_and_seeded():
    a = T._Conv(16, 32, 3, 1, _gen()).weight
    b = T._Conv(16, 32, 3, 1, _gen()).weight
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.std().item(), np.sqrt(2.0 / (32 * 9)), rtol=0.05)
    bn = T._BN(4)
    assert torch.equal(bn.weight, torch.ones(4)) and torch.equal(bn.bias, torch.zeros(4))


def _load_block(tblock, jparams):
    for name, jmod in jparams.items():
        if name == "down":
            _load_convbn(tblock.downsample[0], tblock.downsample[1], jmod)
        else:
            i = name[-1]
            _load_convbn(getattr(tblock, f"conv{i}"), getattr(tblock, f"bn{i}"), jmod)


@pytest.mark.parametrize("kind,cin,planes", [
    ("bottleneck", 16, 8), ("bottleneck", 32, 8), ("basic", 16, 8), ("basic", 8, 8)])
def test_blocks_match_jax(kind, cin, planes):
    x = np.random.default_rng(2).standard_normal((2, 4, 6, 5, cin)).astype(np.float32)
    jcls, tcls = ((J._TSMBottleneck, T._TSMBottleneck) if kind == "bottleneck"
                  else (J._TSMBasicBlock, T._TSMBasicBlock))
    jm = jcls(cin, planes)
    params = _randomized(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tcls(cin, planes, gen=_gen())
    assert hasattr(tm, "downsample") == ("down" in params)
    _load_block(tm, params)
    got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)


def test_flow_refinement_matches_jax():
    rng = np.random.default_rng(4)
    fc = rng.standard_normal((2, 3, 6, 6, 3)).astype(np.float32)
    res = rng.standard_normal((2, 3, 6, 6, 24)).astype(np.float32)
    jm = J._FlowRefinement(24)
    params = _randomized(jm.init(jax.random.key(0), jnp.asarray(fc), jnp.asarray(res))["params"], 5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(fc), jnp.asarray(res)))
    tm = T._FlowRefinement(24, gen=_gen())
    for n in "1234":
        seq = getattr(tm, f"conv{n}")
        _load_convbn(seq[0], seq[1], params[f"dw{n}"])
        _load_convbn(seq[3], seq[4], params[f"pw{n}"])
    got = tm(torch.from_numpy(fc), torch.from_numpy(res))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("patch", [5, 15])
def test_match_to_flow_soft_matches_jax(patch):
    """A ReLU'd volume of L2-normalised features, as the model makes it,
    with one all-zero window (both argmax take the first maximum there)."""
    rng = np.random.default_rng(6)
    match = np.maximum(rng.uniform(-1, 1, (2, 5, 6, patch * patch)), 0).astype(np.float32)
    match[0, 0, 0] = 0.0
    want_flow, want_conf = J._match_to_flow_soft(jnp.asarray(match), patch)
    flow, conf = T._match_to_flow_soft(torch.from_numpy(match), patch)
    assert flow.shape == (2, 5, 6, 2) and conf.shape == (2, 5, 6, 1)
    np.testing.assert_allclose(flow.numpy(), np.asarray(want_flow), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(want_conf))
    assert flow.abs().max() <= 1.0 + 1e-6  # a softmax's weights sum to 1 within rounding


# ------------------------------- the whole net -------------------------------

B, TS, HW, PATCH = 2, 4, 12, 5


@functools.lru_cache(maxsize=None)
def _jax_net(block, flow):
    """The JAX net, its randomised params and the input, from one jitted
    ``init`` (cached: the tests of one case share it). Eager, the init of
    the flow-estimation bottleneck net dispatched op by op for ~25 s."""
    x = np.random.default_rng(7).standard_normal((B, 3, TS, HW, HW)).astype(np.float32)
    jm = J.TSMResNet(layers=(1, 1, 1, 1), block=block, flow_estimation=flow, patch=PATCH)
    params = _randomized(jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))["params"], 8)
    return jm, params, x


def _pair(block, flow, **tkwargs):
    jm, params, x = _jax_net(block, flow)
    tm = T.TSMResNet(layers=(1, 1, 1, 1), block=block, flow_estimation=flow, patch=PATCH,
                     device="cpu", **tkwargs)
    tm.load_state_dict(export_tsm_resnet_state_dict(params), strict=True)
    return jm, params, tm, x


def _gradients(tm, x):
    logits = tm(torch.from_numpy(x))
    names, tensors = zip(*tm.named_parameters())
    grads = torch.autograd.grad(logits.square().sum(), tensors)
    return logits, dict(zip(names, grads))


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
@pytest.mark.parametrize("flow", [True, False])
def test_tsm_resnet_logits_and_gradients_match_jax(block, flow):
    jm, params, tm, x = _pair(block, flow)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(jnp.square(out)), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    logits, grads = _gradients(tm, x)
    assert logits.shape == (B, 1)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    ours = to_jax_params(grads)
    flat_want = jax.tree_util.tree_leaves_with_path(want_grads)
    assert len(flat_want) == len(grads)
    worst = []
    for path, w in flat_want:
        node = ours
        for part in path:
            node = node[part.key]
        w = np.asarray(w)
        gap = np.abs(node - w) / max(np.abs(w).max(), 1e-3)
        name = jax.tree_util.keystr(path)
        worst.append((float(gap.max()), float(gap.mean()), name))
    print("largest gaps (max, mean, parameter):", max(worst),
          max(worst, key=lambda w: w[1]))
    assert max(w[0] for w in worst) <= 0.1, max(worst)
    assert max(w[1] for w in worst) <= 2e-2, max(worst, key=lambda w: w[1])


@pytest.mark.parametrize("builder", ["resnet18_tsm", "resnet34_tsm", "resnet50_tsm",
                                     "resnet101_tsm"])
def test_builders_parameter_names_and_shapes_match_jax(builder):
    x = jax.ShapeDtypeStruct((1, 3, 2, 8, 8), jnp.float32)
    jm = getattr(J, builder)()
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.key(0), a), x)["params"]
    want = {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    tm = getattr(T, builder)(device="cpu")
    assert (tm.layers, tm.block, tm.patch, tm.num_segments) == (
        tuple(jm.layers), jm.block, jm.patch, jm.num_segments)
    ours = to_jax_params(tm.state_dict())
    got = {jax.tree_util.keystr(p): tuple(v.shape)
           for p, v in jax.tree_util.tree_leaves_with_path(ours)}
    assert got == want


def test_constructor_rejects_unknown_block_and_places_on_device():
    with pytest.raises(ValueError, match="block"):
        T.TSMResNet(block="wide", device="cpu")
    tm = T.TSMResNet(layers=(1, 1, 1, 1), flow_estimation=False, device="cpu")
    assert not hasattr(tm, "chnl_reduction")
    assert tm.fc1.weight.shape == (1, 2048, 1)
    assert abs(tm.fc1.weight.std().item() - 0.01) < 2e-3 and tm.fc1.bias.item() == 0.0
