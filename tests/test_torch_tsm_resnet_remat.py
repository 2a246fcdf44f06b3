"""pathtracker_torch.models.tsm_resnet's ``remat`` (each block under
``torch.utils.checkpoint``) and ``fused=False`` (the correlation's plain
version) against the default net, on tests/test_torch_tsm_resnet.py's
whole-net cases (the JAX package's randomised weights carried across): the
same logits and parameter gradients."""

import pytest
import torch

from test_torch_tsm_resnet import _gradients, _pair
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_remat_gives_the_same_logits_and_gradients(block):
    _, _, plain, x = _pair(block, True)
    _, _, remat, _ = _pair(block, True, remat=True)
    l0, g0 = _gradients(plain, x)
    l1, g1 = _gradients(remat, x)
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for name, want in g0.items():
        torch.testing.assert_close(g1[name], want, rtol=1e-6, atol=1e-7,
                                   msg=lambda m, name=name: f"{name}: {m}")
    with torch.no_grad():  # no checkpointing without a gradient
        torch.testing.assert_close(remat(torch.from_numpy(x)), l0, rtol=0, atol=0)


def test_fused_false_takes_the_plain_correlation_with_equal_results():
    _, _, fused, x = _pair("bottleneck", True)
    _, _, plain, _ = _pair("bottleneck", True, fused=False)
    assert fused.fused and not plain.fused
    l0, g0 = _gradients(plain, x)
    l1, g1 = _gradients(fused, x)
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    for name, want in g0.items():
        scale = max(want.abs().max().item(), 1e-3)
        torch.testing.assert_close(g1[name] / scale, want / scale, rtol=0, atol=1e-4)
