"""pathtracker_torch on the card: the CUDA kernels against their plain
versions at the serving path's width, and the fused InT cell against the
eager cell. Every test here is marked ``gpu`` and skips where no CUDA card
is present. This file imports neither JAX nor pathtracker_tpu, so it also
runs where they are not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the suite's shared conftest.py configures JAX).
"""

import pytest
import torch

from pathtracker_torch.models.int_circuit import InT
from pathtracker_torch.ops import int_fused as F

C = 32
BF16 = torch.bfloat16
K1_ARGS = ("exc", "att_x", "a_u", "a_u_b")
K2_ARGS = ("conv_i", "mean0", "rstd0", "scale0", "bias0", "inp", "gi_x", "inh",
           "i_u", "i_u_b", "alpha", "mu")
K3_ARGS = ("conv_e", "mean1", "rstd1", "scale1", "bias1", "new_inh", "inh",
           "gated", "exc", "e_w", "e_w_b", "e_u", "e_u_b", "kappa", "gamma")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(rows, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0, pos=False, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return (torch.nn.functional.softplus(x) if pos else x).to(dtype)

    d = dict(exc=r(rows, C, pos=True), inh=r(rows, C, pos=True),
             new_inh=r(rows, C, pos=True), att_x=r(rows, C, dtype=BF16),
             inp=r(rows, C, pos=True, dtype=BF16), gi_x=r(rows, C, dtype=BF16),
             conv_i=r(rows, C, scale=2.0, dtype=BF16),
             conv_e=r(rows, C, scale=2.0, dtype=BF16),
             gated=r(rows, C, pos=True, dtype=BF16),
             rstd0=r(C, pos=True), rstd1=r(C, pos=True))
    for k in ("a_u", "i_u", "e_w", "e_u"):
        d[k] = r(C, C, scale=C ** -0.5, dtype=BF16)
    for k in ("a_u_b", "i_u_b", "e_w_b", "e_u_b", "mean0", "mean1", "scale0",
              "bias0", "scale1", "bias1", "alpha", "mu", "kappa", "gamma"):
        d[k] = r(C, scale=0.5)
    return d


def _assert_bf16_ulp(a, b):
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)
    assert bool(((a - b).abs() <= ulp).all()), (a - b).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [131072, 1000])
def test_cuda_kernels_match_plain(cuda, rows):
    """Tolerances: f32 outputs atol 1e-5 (expf/log1pf and FMA contraction
    differ by ulps from PyTorch's kernels); bf16 outputs one bf16 ulp."""
    d = _inputs(rows, cuda)
    for wrapper, plain, names in ((F.k1_attention, F.k1_attention_plain, K1_ARGS),
                                  (F.k2_inhibition, F.k2_inhibition_plain, K2_ARGS),
                                  (F.k3_excitation, F.k3_excitation_plain, K3_ARGS)):
        args = [d[k] for k in names]
        before = wrapper.launches
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and a.is_cuda
            if a.dtype == BF16:
                _assert_bf16_ulp(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_cuda_fused_int_matches_eager(cuda):
    """The fused cell on the card against the eager mixed cell with the same
    weights, at tests/test_int_fused.py's shapes and tolerances (1e-4 on
    logits, 1e-3 on states and gates)."""
    x = torch.randn((4, 3, 5, 16, 16), generator=torch.Generator().manual_seed(0))
    x = x.to(cuda)
    fused = InT(dimensions=C, timesteps=5, kernel_size=5, dtype="bfloat16",
                device=cuda)
    eager = InT(dimensions=C, timesteps=5, kernel_size=5, dtype="bfloat16",
                fused=False, device=cuda)
    eager.load_state_dict(fused.state_dict())
    assert fused.use_fused and not eager.use_fused
    before = [k.launches for k in F.KERNELS]
    with torch.no_grad():
        l1, s1, g1 = fused(x, testmode=True)
        l0, s0, g0 = eager(x, testmode=True)
    assert [k.launches - b for k, b in zip(F.KERNELS, before)] == [5, 5, 5]
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s1, s0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(g1, g0, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_cuda_f32_path_matches_cpu(cuda):
    """The f32 parity path on the card (TF32 off) against the CPU."""
    x = torch.randn((3, 3, 5, 12, 12), generator=torch.Generator().manual_seed(1))
    cpu = InT(dimensions=8, timesteps=5, kernel_size=5, device="cpu")
    card = InT(dimensions=8, timesteps=5, kernel_size=5, device=cuda)
    card.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        want = cpu(x, testmode=True)
        got = card(x.to(cuda), testmode=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
