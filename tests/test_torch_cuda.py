"""pathtracker_torch on the card: the CUDA kernels, forward and backward,
against their plain versions at the main path's width, the fused InT
cell against the eager cell, outputs and gradients, and the correlation
kernels and a small TSMResNet through them against the plain correlation.
Every test here is marked ``gpu`` and skips where no CUDA card is present. This file imports neither JAX nor pathtracker_tpu, so it also
runs where they are not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(``--noconftest``: the suite's shared conftest.py configures JAX).
"""

import os
import sys

import pytest
import torch

from pathtracker_torch.models.int_circuit import InT
from pathtracker_torch.models.tsm_resnet import TSMResNet
from pathtracker_torch.ops import _native
from pathtracker_torch.ops import correlation as corr
from pathtracker_torch.ops import int_fused as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

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
    # Every kernel library is built and loaded before the first test: one
    # that is built and loaded after torch.profiler first ran in the process
    # has its kernels missing, in part or whole, from later profiles.
    for name in _native.SIGNATURES:
        _native._library(name)
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


# Row counts around the edges of the ring kernels' tiling (16 rows a warp,
# 128 a block) besides the main path's 131,072.
RAGGED_ROWS = [1, 15, 17, 63, 65, 1000, 131072 + 5]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [131072] + RAGGED_ROWS)
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


def _cotangents(rows, dev, seed=7):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(dtype):
        return torch.randn((rows, C), generator=gen, device=dev).to(dtype)

    return dict(dgated=r(BF16), datt=r(torch.float32), dnew=r(torch.float32))


def _bwd_cases(d, ct):
    """(name, wrapper, plain, arguments) for each backward kernel; K1 with
    and without a cotangent for the attention map."""
    k1 = [d[k] for k in K1_ARGS]
    return [
        ("k1+datt", F.k1_attention_bwd, F.k1_attention_bwd_plain,
         k1 + [ct["dgated"], ct["datt"]]),
        ("k1", F.k1_attention_bwd, F.k1_attention_bwd_plain, k1 + [ct["dgated"]]),
        ("k2", F.k2_inhibition_bwd, F.k2_inhibition_bwd_plain,
         [d[k] for k in K2_ARGS] + [ct["dnew"]]),
        ("k3", F.k3_excitation_bwd, F.k3_excitation_bwd_plain,
         [d[k] for k in K3_ARGS] + [ct["dnew"]]),
    ]


def _ring_cases(d, ct):
    """(name, call returning a tuple, the wrapper that counts its launches,
    arguments) for each ring kernel: K2 forward and the backward kernels."""
    def k2(*args):
        return (F.k2_inhibition(*args),)

    return [("k2 forward", k2, F.k2_inhibition, [d[k] for k in K2_ARGS])] + [
        (name, wrapper, wrapper, args) for name, wrapper, _, args in _bwd_cases(d, ct)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [131072] + RAGGED_ROWS)
def test_cuda_backward_kernels_match_plain(cuda, rows):
    """Tolerances, cotangents being O(1), each relative to the output's
    largest entry (at least 1). Row outputs: a transposed product takes its
    cotangent rounded to bf16, so where kernel and plain version differ by
    f32 ulps before that rounding one operand moves by a bf16 ulp: every
    element within 2^-8, and all but one in a thousand within 1e-5 (f32) or
    one bf16 ulp (bf16). Reductions over the rows (weight gradients,
    per-channel sums): 1e-3 for f32 sums of ``rows`` terms taken in another
    order, plus one bf16 ulp where the result is rounded to bf16."""
    d, ct = _inputs(rows, cuda), _cotangents(rows, cuda)
    problems = []
    for name, wrapper, plain, args in _bwd_cases(d, ct):
        before = wrapper.launches
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        want = plain(*args)
        assert len(got) == len(want), name
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.is_cuda, (name, i)
            assert bool(torch.isfinite(a).all()), (name, i)
            a32, b32 = a.float(), b.float()
            diff = (a32 - b32).abs()
            scale = max(b32.abs().max().item(), 1.0)
            if a.shape[0] != rows:  # a reduction over the rows
                tol = 1e-3 + (2.0 ** -7 if a.dtype == BF16 else 0.0)
                if diff.max().item() > tol * scale:
                    problems.append((name, i, "reduction", diff.max().item(), scale))
                continue
            if a.dtype == BF16:
                mag = torch.maximum(a32.abs(), b32.abs()).clamp_min(1e-30)
                tight = torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)
            else:
                tight = torch.full_like(diff, 1e-5 * scale)
            if bool((diff > tight.clamp_min(2.0 ** -8 * scale)).any()):
                problems.append((name, i, "row", diff.max().item(), scale))
            if (diff > tight).float().mean().item() > 1e-3:
                problems.append((name, i, "share", (diff > tight).float().mean().item()))
    assert not problems, problems


@pytest.mark.gpu
def test_cuda_backward_kernels_are_deterministic(cuda):
    """No float atomics: two launches on the same inputs give the same bits,
    the cross-row reductions included (and K2 forward's rows)."""
    d, ct = _inputs(131072, cuda), _cotangents(131072, cuda)
    for name, call, _, args in _ring_cases(d, ct):
        first = call(*args)
        second = call(*args)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, second)):
            assert torch.equal(a, b), (name, i)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", RAGGED_ROWS)
def test_cuda_backward_kernels_are_deterministic_at_ragged_sizes(cuda, rows):
    """As above where the last tile is partial, or most warps have none."""
    d, ct = _inputs(rows, cuda), _cotangents(rows, cuda)
    for name, call, _, args in _ring_cases(d, ct):
        first = call(*args)
        second = call(*args)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, second)):
            assert torch.equal(a, b), (name, i)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [131072] + RAGGED_ROWS)
def test_cuda_backward_kernels_replay_in_a_cuda_graph(cuda, rows):
    """Each ring kernel's wrapper (K2 forward, K1-K3 backward) launched
    twice in a row inside a captured CUDA graph: every replay gives the eager
    launch's bits, the reductions that the launch finishes on the card
    included."""
    d, ct = _inputs(rows, cuda), _cotangents(rows, cuda)
    for name, call, counted, args in _ring_cases(d, ct):
        eager = [t.clone() for t in call(*args)]  # also loads the kernel
        torch.cuda.synchronize()
        before = counted.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            first = call(*args)
            second = call(*args)
        assert counted.launches == before + 2, name
        for _ in range(3):
            for t in (*first, *second):
                t.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            for i, want in enumerate(eager):
                assert torch.equal(first[i], want), (name, "first", i)
                assert torch.equal(second[i], want), (name, "second", i)


@pytest.mark.gpu
def test_cuda_backward_call_is_two_kernels(cuda):
    """A backward wrapper's call is its phase's kernel and finish_kernel,
    which sums the per-block partials: no PyTorch kernel of its own."""
    from torch.profiler import ProfilerActivity, profile

    d, ct = _inputs(131072, cuda), _cotangents(131072, cuda)
    mains = {"k1+datt": "k1_bwd_kernel", "k1": "k1_bwd_kernel", "k2": "k2_bwd_kernel",
             "k3": "k3_bwd_kernel"}
    for name, wrapper, _, args in _bwd_cases(d, ct):
        wrapper(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wrapper(*args)
            torch.cuda.synchronize()
        seen = sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        assert len(seen) == 2, (name, seen)
        assert sum(mains[name] in k for k in seen) == 1, (name, seen)
        assert sum("finish_kernel" in k for k in seen) == 1, (name, seen)


@pytest.mark.gpu
def test_cuda_fused_int_gradients_match_eager(cuda):
    """Gradients through the fused cell on the card (backward kernels, the
    recomputing step) against the eager mixed cell's, normalised by each
    parameter's largest entry: atol 6e-3 as tests/test_int_fused.py holds the
    JAX fused cell to (the paths round their bf16 cotangents at different
    points). Each forward kernel launches 2T times, each backward one T."""
    x = torch.randn((4, 3, 5, 16, 16), generator=torch.Generator().manual_seed(0))
    x = x.to(cuda)
    fused = InT(dimensions=C, timesteps=5, kernel_size=5, dtype="bfloat16",
                device=cuda)
    eager = InT(dimensions=C, timesteps=5, kernel_size=5, dtype="bfloat16",
                fused=False, device=cuda)
    eager.load_state_dict(fused.state_dict())
    before = [k.launches for k in F.KERNELS]
    grads = {}
    for name, model in (("fused", fused), ("eager", eager)):
        logit, _ = model(x)
        logit.square().sum().backward()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    assert [k.launches - b for k, b in zip(F.KERNELS, before)] == [10] * 3 + [5] * 3
    for key, want in grads["eager"].items():
        got = grads["fused"][key]
        if want is None:
            assert got is None, key
            continue
        scale = max(want.abs().max().item(), 1e-3)
        torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=6e-3,
                                   msg=lambda m: f"{key}: {m}")


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
    assert [k.launches - b for k, b in zip(F.KERNELS, before)] == [5, 5, 5, 0, 0, 0]
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


# (N, H, W, C, patch, dilation): the serving path's shape at a small N, the
# JAX tests' cases, odd sizes with ragged tiles and a channel count that is
# no multiple of 4 or 16, two displacement groups per axis, a wide dilation,
# two 64-channel chunks, rntsm's patch at dilation 2 (the runtime-patch
# instance), and the rntsm train step's shape (4 clips x 63 frame pairs).
CORRELATION_CASES = [(3, 32, 32, 64, 15, 1), (2, 8, 8, 4, 5, 1), (1, 12, 12, 4, 5, 2),
                     (2, 7, 9, 3, 3, 1), (1, 37, 41, 21, 7, 1), (1, 20, 35, 24, 17, 1),
                     (1, 9, 40, 8, 9, 3), (1, 5, 6, 70, 1, 1), (2, 16, 16, 128, 15, 1),
                     (1, 24, 24, 16, 15, 2), (4, 32, 32, 64, 15, 1),
                     (252, 32, 32, 64, 15, 1)]


def _correlation_inputs(n, h, w, c, patch, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    f1 = corr.l2_normalize(torch.randn((n, h, w, c), generator=gen, device=dev))
    f2 = corr.l2_normalize(torch.randn((n, h, w, c), generator=gen, device=dev))
    g = torch.randn((n, h, w, patch * patch), generator=gen, device=dev)
    return f1, f2, g


@pytest.mark.gpu
@pytest.mark.parametrize("case", CORRELATION_CASES, ids=str)
def test_cuda_correlation_kernels_match_plain(cuda, case):
    """Forward: f32 sums of C products of L2-normalised features (|sum| <= 1)
    in another order, atol 1e-5. Backward: sums of patch^2 terms g*f with
    g ~ N(0,1) and |f| <= 1, atol 1e-4. Each wrapper launches once; two
    launches of a kernel give the same bits (no float atomics)."""
    n, h, w, c, patch, dil = case
    f1, f2, g = _correlation_inputs(n, h, w, c, patch, cuda)
    before = [k.launches for k in corr.KERNELS]
    out = corr.correlation(f1, f2, patch, dil)
    df1 = corr.correlation_bwd_f1(g, f2, patch, dil)
    df2 = corr.correlation_bwd_f2(g, f1, patch, dil)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(corr.KERNELS, before)] == [1, 1, 1]
    torch.testing.assert_close(out, corr.correlation_plain(f1, f2, patch, dil),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(df1, corr.correlation_bwd_f1_plain(g, f2, patch, dil),
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(df2, corr.correlation_bwd_f2_plain(g, f1, patch, dil),
                               rtol=0, atol=1e-4)
    assert torch.equal(out, corr.correlation(f1, f2, patch, dil))
    assert torch.equal(df1, corr.correlation_bwd_f1(g, f2, patch, dil))
    assert torch.equal(df2, corr.correlation_bwd_f2(g, f1, patch, dil))


@pytest.mark.gpu
def test_cuda_correlation_autograd_runs_the_backward_kernels(cuda):
    f1, f2, g = _correlation_inputs(2, 16, 16, 64, 15, cuda, seed=1)
    f1.requires_grad_(), f2.requires_grad_()
    before = [k.launches for k in corr.KERNELS]
    got = torch.autograd.grad(corr.correlation(f1, f2, 15), (f1, f2), g)
    assert [k.launches - b for k, b in zip(corr.KERNELS, before)] == [1, 1, 1]
    want = torch.autograd.grad(corr.correlation_plain(f1, f2, 15), (f1, f2), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(3, 32, 32, 64, 15, 1), (1, 37, 41, 21, 7, 1)], ids=str)
def test_cuda_correlation_backward_replays_in_a_cuda_graph(cuda, case):
    """Both backward wrappers launched twice in a row inside a captured CUDA
    graph: every replay gives the bits of a direct launch."""
    n, h, w, c, patch, dil = case
    f1, f2, g = _correlation_inputs(n, h, w, c, patch, cuda, seed=2)
    calls = ((corr.correlation_bwd_f1, f2), (corr.correlation_bwd_f2, f1))
    eager = [fn(g, feat, patch, dil).clone() for fn, feat in calls]
    torch.cuda.synchronize()
    before = [fn.launches for fn, _ in calls]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [(fn(g, feat, patch, dil), fn(g, feat, patch, dil)) for fn, feat in calls]
    assert [fn.launches - b for (fn, _), b in zip(calls, before)] == [2, 2]
    for _ in range(3):
        for pair in outs:
            for t in pair:
                t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for want, pair in zip(eager, outs):
            assert all(torch.equal(t, want) for t in pair)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(3, 32, 32, 64, 15, 1), (1, 37, 41, 21, 7, 1)], ids=str)
def test_cuda_correlation_forward_replays_in_a_cuda_graph(cuda, case):
    """The forward wrapper launched twice in a row inside a captured CUDA
    graph: every replay gives the bits of a direct launch."""
    n, h, w, c, patch, dil = case
    f1, f2, _ = _correlation_inputs(n, h, w, c, patch, cuda, seed=2)
    eager = corr.correlation(f1, f2, patch, dil).clone()
    torch.cuda.synchronize()
    before = corr.correlation.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (corr.correlation(f1, f2, patch, dil), corr.correlation(f1, f2, patch, dil))
    assert corr.correlation.launches - before == 2
    for _ in range(3):
        for t in outs:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(t, eager) for t in outs)


@pytest.mark.gpu
def test_cuda_correlation_forward_call_is_one_kernel(cuda):
    """A forward wrapper's call is one corr_fwd_kernel launch and nothing
    else on the card: 10 profiled calls, 10 kernels."""
    from torch.profiler import ProfilerActivity, profile

    calls = 10
    f1, f2, _ = _correlation_inputs(3, 32, 32, 64, 15, cuda)
    corr.correlation(f1, f2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            corr.correlation(f1, f2)
        torch.cuda.synchronize()
    seen = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(seen) == calls and all("corr_fwd_kernel" in k for k in seen), seen


@pytest.mark.gpu
def test_cuda_correlation_backward_call_is_one_kernel(cuda):
    """A backward wrapper's call is one corr_bwd_kernel launch and nothing
    else on the card: 10 profiled calls, 10 kernels."""
    from torch.profiler import ProfilerActivity, profile

    calls = 10
    f1, f2, g = _correlation_inputs(3, 32, 32, 64, 15, cuda)
    for fn, feat in ((corr.correlation_bwd_f1, f2), (corr.correlation_bwd_f2, f1)):
        fn(g, feat)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(g, feat)
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(seen) == calls and all("corr_bwd_kernel" in k for k in seen), (
            fn.__name__, seen)


@pytest.mark.gpu
def test_cuda_correlation_refuses_a_window_no_block_can_hold(cuda):
    """patch 15 at dilation 40: the shared-memory tile exceeds 227 KB even at
    one row; each launch is refused and its wrapper raises."""
    f1, f2, g = _correlation_inputs(1, 8, 8, 4, 15, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        corr.correlation(f1, f2, 15, 40)
    with pytest.raises(RuntimeError, match="CUDA error"):
        corr.correlation_bwd_f1(g, f2, 15, 40)
    with pytest.raises(RuntimeError, match="CUDA error"):
        corr.correlation_bwd_f2(g, f1, 15, 40)


@pytest.mark.gpu
def test_cuda_tsm_resnet_fused_matches_plain_correlation(cuda):
    """A small TSMResNet through the correlation kernels against the same
    weights through the plain correlation: logits atol 1e-4 (the volumes
    differ by f32 rounding; an argmax that flips between near-equal maxima
    moves one pixel's flow), and one launch of each kernel per
    forward/backward."""
    x = torch.randn((2, 3, 4, 16, 16), generator=torch.Generator().manual_seed(0)).to(cuda)
    fused = TSMResNet(layers=(1, 1, 1, 1), device=cuda)
    plain = TSMResNet(layers=(1, 1, 1, 1), fused=False, device=cuda)
    plain.load_state_dict(fused.state_dict())
    before = [k.launches for k in corr.KERNELS]
    with torch.no_grad():
        got = fused(x)
        want = plain(x)
    assert [k.launches - b for k, b in zip(corr.KERNELS, before)] == [1, 0, 0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    fused(x).square().sum().backward()
    assert [k.launches - b for k, b in zip(corr.KERNELS, before)] == [2, 1, 1]
    plain(x).square().sum().backward()
    assert [k.launches - b for k, b in zip(corr.KERNELS, before)] == [2, 1, 1]
    for (name, p), q in zip(fused.named_parameters(), plain.parameters()):
        scale = max(q.grad.abs().max().item(), 1e-3)
        assert ((p.grad - q.grad).abs().max() / scale).item() <= 0.1, name


@pytest.mark.gpu
def test_cuda_evaluate_model_runs_the_fused_kernels(cuda, tmp_path, monkeypatch):
    """evaluate_model (InT, 32 channels, --bf16, batch 4, T=8, the chainE
    weights) on a rendered test split of two batches: T launches of each
    forward kernel a batch and none backward, the test_perf npz written.
    Where the native reader builds, every ShardView the loader opened is
    closed again, and the batches it gathered out of the pooled decode
    buffers hold the clips the Python codec decodes from the same shards."""
    import glob
    import os
    from types import SimpleNamespace

    import numpy as np

    from pathtracker_torch.data import native, registry
    from pathtracker_torch.data.pathtracker import make_synthetic_dataset
    from pathtracker_torch.data.pipeline import tfr_data_loader
    from pathtracker_torch.data.tfrecord import read_clip_records
    from pathtracker_torch.eval import test_model

    timesteps, batch = 8, 4
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    root = registry._config_dir(14, 1, timesteps)
    make_synthetic_dataset(root, n_train=0, n_test=2 * batch, timesteps=timesteps)
    opened = []

    class Recorded(native.ShardView):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            opened.append(self)

    monkeypatch.setattr(native, "ShardView", Recorded)
    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "results_conv", "64_1_14", "chainE", "saved_models",
                        "model_val_acc_0072_epoch_15_checkpoint.pth.tar")
    args = SimpleNamespace(model="InT", batch_size=batch, bf16=True, dimensions=C,
                           fb_kernel_size=7, ckpt=ckpt, pretrained=False, algo="bptt",
                           device="cuda")
    before = [k.launches for k in F.KERNELS]
    acc, loss = test_model.evaluate_model(str(tmp_path / "out"), args, prep_gifs=0,
                                          dist=14, speed=1, length=timesteps)
    assert [k.launches - b for k, b in zip(F.KERNELS, before)] == [2 * timesteps] * 3 + [0] * 3
    saved = np.load(tmp_path / "out" / f"test_perf_dist_14_speed_1_length_{timesteps}.npz")
    assert saved.files == ["arr_0", "arr_1"] and (float(saved["arr_0"]), float(saved["arr_1"])) == (acc, loss)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    if native.available():
        assert len(opened) == 2 and all(v._handle is None for v in opened)
        records = {c.tobytes(): y for path in sorted(glob.glob(os.path.join(root, "test-*")))
                   for c, y in read_clip_records(path, timesteps)}
        seen = 0
        for clips, labels in tfr_data_loader(os.path.join(root, "test-*"), batch_size=batch,
                                             timesteps=timesteps, seed=0):
            for clip, label in zip(clips, labels):
                assert records[clip.tobytes()] == label
                seen += 1
        assert seen == len(records) == 2 * batch


@pytest.mark.gpu
def test_cuda_rolling_checkpoint_reads_back_bit_equal_onto_the_card(cuda, tmp_path):
    """Weights and optimizer state (EMA and accumulation included) written
    from CUDA tensors after two fused bf16 train steps read back bit-equal
    into a fresh model and optimizer on the card."""
    import numpy as np

    from pathtracker_torch import engine
    from pathtracker_torch.train import checkpoint as ckpt
    from pathtracker_torch.train import loop
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    def build(seed):
        model = InT(dimensions=C, timesteps=4, kernel_size=3, dtype="bfloat16",
                    seed=seed, device=cuda)
        names, params = loop._trained(model)
        opt = make_optimizer(1e-3, ema=0.9, accum_steps=2, clip_grad=1.0).init(params)
        return model, names, opt

    model, names, opt = build(0)
    step = make_train_step(model, "InT", opt)
    rng = np.random.default_rng(0)
    for _ in range(3):
        step(rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8),
             np.array([0, 1], np.uint8))
    path = str(tmp_path / "roll.pth.tar")
    ckpt.save_checkpoint(path, model.state_dict(), epoch=0,
                         extra=loop._opt_state_extra(opt, names))
    other, _, fresh = build(1)
    engine.load_ckpt(other, path)
    fresh.load_state_dict(ckpt.load_checkpoint(path)["extra"]["opt_state"], names, "InT")
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert b.is_cuda and torch.equal(a, b), k
    for a, b in zip(opt.mu + opt.nu + opt.acc + opt.ema, fresh.mu + fresh.nu + fresh.acc + fresh.ema):
        assert b.is_cuda and torch.equal(a, b)
    assert (fresh.count, fresh.mini_step) == (opt.count, opt.mini_step) == (1, 1)


@pytest.mark.gpu
def test_cuda_auto_resume_restores_the_moments_onto_the_card(cuda, tmp_path, monkeypatch):
    """python -m pathtracker_torch.train's main on the card, --bf16 at 32
    channels, relaunched with --auto-resume: the optimizer the second run
    starts from holds the first run's moments, bit-equal and on the card,
    and the Adam count continues."""
    from pathtracker_torch.train import loop

    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.setenv("PATHTRACKER_SYNTH_TRAIN", "8")
    monkeypatch.setenv("PATHTRACKER_SYNTH_TEST", "8")
    starts, optimizers = [], []
    real = loop.make_train_step

    def recorded(model, name, optimizer, **kw):
        starts.append((optimizer.count, [t.clone() for t in optimizer.mu + optimizer.nu]))
        optimizers.append(optimizer)
        return real(model, name, optimizer, **kw)

    monkeypatch.setattr(loop, "make_train_step", recorded)
    argv = ["--model", "InT", "--name", "r", "--length", "4", "--speed", "1", "--dist",
            "1", "-b", "4", "-k", "3", "--bf16", "--auto-resume", "--results-dir",
            str(tmp_path / "out")]
    loop.main(loop.parser.parse_args(argv + ["--epochs", "1"]), max_steps_per_epoch=2)
    first = optimizers[-1]
    loop.main(loop.parser.parse_args(argv + ["--epochs", "2"]), max_steps_per_epoch=2)
    count, moments = starts[-1]
    assert count == first.count == 2 and optimizers[-1].count == 4
    for a, b in zip(first.mu + first.nu, moments):
        assert b.is_cuda and torch.equal(a, b)


# ------------------ resident windows: CUDA graphs vs eager -------------------

def _resident_pair(cuda, optimizer_kw, fused_steps, n_clips=16, batch=4, timesteps=4):
    """Two copies of one small fused bf16 InT with their optimizers: one
    driven by make_resident_train_step (graph windows), the other by
    make_train_step (eager steps) on the batches the windows gather."""
    import numpy as np

    from pathtracker_torch.data.resident import make_resident_train_step
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.integers(0, 256, (n_clips, timesteps, 32, 32, 3),
                                          dtype=np.uint8)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 2, (n_clips,), dtype=np.uint8)).to(cuda)
    models = [InT(dimensions=C, timesteps=timesteps, kernel_size=3, dtype="bfloat16",
                  seed=0, device=cuda) for _ in range(2)]
    opts = [make_optimizer(**optimizer_kw) for _ in range(2)]
    graphed = make_resident_train_step(models[0], "InT", opts[0], n_clips=n_clips,
                                       batch_size=batch, fused_steps=fused_steps)
    eager = make_train_step(models[1], "InT", opts[1])
    return clips, labels, models, opts, graphed, eager


def _assert_window_matches_eager(opts, models, lr, steps):
    """chip_smoke.py's rule: bit-identical unless cuDNN's weight-gradient
    algorithm is nondeterministic; then Adam's sign-like update can move an
    entry whose gradient sits at rounding distance from zero by up to 2*lr a
    step, so every entry is held within 2*lr*steps and all but one in a
    hundred within lr/100. A rate baked into the graph at capture moves
    nearly every entry by a tenth of lr or more."""
    account, held = chip_smoke.window_account(models, opts, lr, steps)
    assert held, account


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(fused_steps=3, windows=2, graphs=2, lr=1e-3, optimizer=dict(lr=1e-3)),
    dict(fused_steps=2, windows=2, graphs=1, lr=4e-3, optimizer=dict(
        lr=1e-3, schedule=lambda count: 1e-3 * (1 + count))),
    dict(fused_steps=2, windows=3, graphs=3, lr=1e-3,
         optimizer=dict(lr=1e-3, accum_steps=3, ema=0.9)),
], ids=["k3-and-tail", "two-replays-two-rates", "accumulation-phases"])
def test_cuda_resident_windows_match_eager_steps(cuda, case, monkeypatch):
    """Graph windows against eager steps on the same batches: a window of 3
    then the epoch's tail of 1 (two graphs); one graph replayed for two
    windows under a rate that changes every step (``lr``: the largest);
    windows of 2 under accumulation over 3, whose phases at a window's start
    run 0, 2, 1 (a graph each). cuDNN's deterministic algorithms: its
    default ones can sum a weight gradient in another order each run."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    clips, labels, models, opts, graphed, eager = _resident_pair(
        cuda, case["optimizer"], case["fused_steps"])
    losses, steps = [], 0
    for _ in range(case["windows"]):
        stats = graphed(clips, labels)
        for j, loss in enumerate(stats["loss"]):
            idx = graphed.indices(steps + j)
            want = eager(clips.index_select(0, idx), labels.index_select(0, idx))
            losses.append((float(loss), float(want["loss"])))
        steps += len(stats["loss"])
    assert len(graphed.graphs) == case["graphs"]
    for got, want in losses:
        assert abs(got - want) <= 1e-4, losses
    _assert_window_matches_eager(opts, models, case["lr"], steps)


@pytest.mark.gpu
def test_cuda_resident_window_refuses_cpu_clips(cuda):
    _, labels, _, _, graphed, _ = _resident_pair(cuda, dict(lr=1e-3), 2)
    with pytest.raises(ValueError, match="resident clips on cpu"):
        graphed(torch.zeros((16, 4, 32, 32, 3), dtype=torch.uint8), labels)
    assert not graphed.graphs


@pytest.mark.gpu
def test_cuda_slowfast_dropout_draws_in_resident_windows(cuda):
    """A small SlowFast (width 8, two stages) through graph windows of 2:
    the step's generator is registered with each captured graph, so the
    dropout draws on every replay; the losses are finite, one graph serves
    both windows, and the first window's first loss differs from the same
    weights' without dropout on the same batch."""
    import numpy as np

    from pathtracker_torch.data.resident import make_resident_train_step
    from pathtracker_torch.models.registry import model_selector
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.integers(0, 256, (8, 8, 32, 32, 3), dtype=np.uint8)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, 2, (8,), dtype=np.uint8)).to(cuda)
    models = [model_selector("slowfast", timesteps=8, width=8, stage_blocks=(1, 1),
                             dropout_rate=rate, device=cuda) for rate in (0.5, 0.0)]
    graphed = make_resident_train_step(models[0], "slowfast", make_optimizer(1e-3),
                                       n_clips=8, batch_size=2, fused_steps=2)
    idx = graphed.indices(0)
    plain = make_train_step(models[1], "slowfast", make_optimizer(1e-3))(
        clips.index_select(0, idx), labels.index_select(0, idx))
    losses = [float(v) for _ in range(2) for v in graphed(clips, labels)["loss"]]
    assert len(graphed.graphs) == 1 and all(np.isfinite(losses)), losses
    assert losses[0] != float(plain["loss"])


VIZ_ROWS = 40 * 32 * 32  # viz_InT.sh's batch of 40: 40,960 rows


@pytest.mark.gpu
def test_cuda_backward_kernels_match_plain_at_the_viz_rows(cuda):
    """The three backward wrappers at the viz path's 40,960 rows, K1 without
    the attention map's cotangent (the case the viz step launches), at
    test_cuda_backward_kernels_match_plain's tolerances."""
    test_cuda_backward_kernels_match_plain(cuda, VIZ_ROWS)


@pytest.mark.gpu
def test_cuda_viz_step_launches_every_k1_k3_kernel_once_a_frame(cuda):
    """attribution_step with the parameters frozen: the gradient reaches the
    clips through every K1-K3 backward kernel, T launches each, and every
    forward kernel runs 2T times (the forward and each step's recompute)."""
    import numpy as np

    from pathtracker_torch.eval.viz import attribution_step

    t = 4
    model = InT(dimensions=C, timesteps=t, kernel_size=3, dtype="bfloat16", device=cuda)
    for p in model.parameters():
        p.requires_grad_(False)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (6, t, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, (6,), dtype=np.uint8)
    for k in F.KERNELS:
        k.launches = 0
    out = attribution_step(model, "InT", raw, labels, np.full(6, 0.7, np.float32))
    torch.cuda.synchronize()
    assert [k.launches for k in F.FORWARD_KERNELS] == [2 * t] * 3
    assert [k.launches for k in F.BACKWARD_KERNELS] == [t] * 3
    pos, neg = out[3], out[4]
    assert pos.shape == (6, 3, t, 32, 32) and bool(torch.isfinite(pos).all())
    assert float(pos.max()) > 0 and float(neg.max()) > 0


@pytest.mark.gpu
def test_cuda_exported_program_is_exact_and_launches_the_kernels(cuda, tmp_path):
    import numpy as np

    from pathtracker_torch.eval import serve

    t = 4
    model = InT(dimensions=C, timesteps=t, kernel_size=3, dtype="bfloat16", device=cuda).eval()
    path = str(tmp_path / "int.pt2")
    serve.save_exported(serve.export_program(model, "InT", t), path)
    served = serve.load_exported(path)
    live = serve.make_inference_fn(model, "InT")
    for batch in (8, 3):
        x = np.random.default_rng(batch).integers(0, 256, (batch, t, 32, 32, 3), np.uint8)
        for k in F.KERNELS:
            k.launches = 0
        got = served(x)
        torch.cuda.synchronize()
        assert [k.launches for k in F.FORWARD_KERNELS] == [t] * 3
        assert got.is_cuda and torch.equal(got, live(x))


@pytest.mark.gpu
def test_cuda_programs_serve_on_their_platforms(cuda, tmp_path):
    """--platforms: a cpu,cuda program exported on the card serves on the
    CPU (the kernels' plain versions), its scores held to the card's by
    chip_smoke's phase-4 rule for two mixed paths (the convs sum in another
    order there); one exported on the CPU serves on the card through K1-K3,
    held to the live model the same way; a cuda-only program is refused on
    the CPU, with an error that names its platforms."""
    import numpy as np

    from pathtracker_torch.eval import serve

    t = 4
    card = InT(dimensions=C, timesteps=t, kernel_size=3, dtype="bfloat16", device=cuda).eval()
    cpu = InT(dimensions=C, timesteps=t, kernel_size=3, dtype="bfloat16", device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = np.random.default_rng(7).integers(0, 256, (6, t, 32, 32, 3), np.uint8)
    live = serve.make_inference_fn(card, "InT")(x)

    from_card = str(tmp_path / "card.pt2")
    serve.save_exported(serve.export_program(card, "InT", t), from_card)
    on_card = serve.load_exported(from_card)
    assert on_card.device.type == "cuda" and torch.equal(on_card(x), live)
    before = [k.launches for k in F.KERNELS]
    on_cpu = serve.load_exported(from_card, device="cpu")(x)
    assert [k.launches for k in F.KERNELS] == before
    assert on_cpu.device.type == "cpu"
    assert chip_smoke._served_alike(on_cpu, live)

    from_cpu = str(tmp_path / "cpu.pt2")
    serve.save_exported(serve.export_program(cpu, "InT", t), from_cpu)
    served = serve.load_exported(from_cpu)
    for k in F.KERNELS:
        k.launches = 0
    moved = served(x)
    torch.cuda.synchronize()
    assert served.device.type == "cuda" and moved.is_cuda
    assert [k.launches for k in F.FORWARD_KERNELS] == [t] * 3
    assert chip_smoke._served_alike(moved, live)

    card_only = str(tmp_path / "cuda.pt2")
    serve.save_exported(serve.export_program(card, "InT", t), card_only, platforms="cuda")
    assert serve.load_exported(card_only).device.type == "cuda"
    with pytest.raises(ValueError, match="platforms cuda, not cpu"):
        serve.load_exported(card_only, device="cpu")


@pytest.mark.gpu
def test_cuda_rbp_step_runs_the_eager_cell(cuda):
    """--algo rbp --bf16 at 32 channels: no K1-K3 launch, finite gradients,
    the Neumann terms counted."""
    import numpy as np

    from pathtracker_torch.ops import rbp
    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    model = InT(dimensions=C, timesteps=4, kernel_size=3, dtype="bfloat16",
                grad_method="rbp", device=cuda)
    assert not model.use_fused
    step = make_train_step(model, "InT", make_optimizer(3e-4))
    rng = np.random.default_rng(0)
    for k in F.KERNELS:
        k.launches = 0
    rbp.neumann_rbp.terms.clear()
    stats = step(rng.integers(0, 256, (4, 4, 32, 32, 3), np.uint8),
                 rng.integers(0, 2, (4,), np.uint8))
    assert [k.launches for k in F.KERNELS] == [0] * 6
    assert np.isfinite(stats["loss"]) and len(rbp.neumann_rbp.terms) == 1


@pytest.mark.gpu
def test_cuda_resident_windows_refuse_rbp(cuda):
    from pathtracker_torch.data.resident import make_resident_train_step
    from pathtracker_torch.train.steps import make_optimizer

    model = InT(dimensions=C, timesteps=4, kernel_size=3, dtype="bfloat16",
                grad_method="rbp", device=cuda)
    with pytest.raises(ValueError, match="rbp"):
        make_resident_train_step(model, "InT", make_optimizer(1e-3), n_clips=8,
                                 batch_size=4, fused_steps=4)


def _two_gloo_ranks(tmp_path, cases):
    """tests/torch_parallel_worker.py on the card as two gloo ranks (NCCL
    takes one card a rank): their results."""
    import subprocess

    torch.save(cases, tmp_path / "in.pt")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
    procs, logs = [], []
    for rank in range(2):
        logs.append(open(tmp_path / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(rank), "2", str(tmp_path / "store"),
             str(tmp_path / "in.pt"), str(tmp_path / f"out{rank}.pt"), "cuda", "gloo"],
            stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{rank}.log").read_text()[-4000:]
    return [torch.load(tmp_path / f"out{rank}.pt") for rank in range(2)]


@pytest.mark.gpu
def test_cuda_two_gloo_ranks_step_as_one_process(cuda, tmp_path, monkeypatch):
    """Two ranks on the card, each a process taking half of a global batch
    of 8 through the fused bf16 cell (the K1-K3 kernels launched on each),
    against one process's step on the whole batch from the same weights:
    tests/test_parallel.py's bf16 tolerances, loss rtol 1e-4 and weights
    atol 5e-4, the weights by an Adam rule: every entry within 2*lr, and
    within the atol where the gradient clears a hundredth of its parameter's
    largest, but for one in a hundred of those. Adam's first update is
    sign-like, lr*g/(|g|+eps), and each rank's conv weight gradient leaves
    cuDNN rounded to bf16, so the ranks' sum is not one process's rounding
    of the whole: an entry whose gradient is small beside its halves may
    flip (seen: 13 of 9,216 in w_exc, each within 2*lr)."""
    import numpy as np

    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    lr, model = 1e-3, dict(dimensions=C, timesteps=4, kernel_size=3, dtype="bfloat16")
    state = {k: v.cpu() for k, v in InT(seed=0, device=cuda, **model).state_dict().items()}
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.integers(0, 256, (1, 8, 4, 32, 32, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, (1, 8), dtype=np.uint8))
    ranks = _two_gloo_ranks(tmp_path, {"step": dict(
        kind="step", model=model, state=state, lr=lr, penalty=False, clips=clips,
        labels=labels)})
    one = InT(device=cuda, **model)
    one.load_state_dict(state)
    opt = make_optimizer(lr)
    want = make_train_step(one, "InT", opt)(clips[0].to(cuda), labels[0].to(cuda))
    rms = dict(zip([n for n, p in one.named_parameters() if p.requires_grad],
                   (v.sqrt() for v in opt.nu)))
    got = [r["step"] for r in ranks]
    for r in got:
        assert bool(r["fused"]) and (r["launches"] == torch.tensor([8, 8, 8, 4, 4, 4])).all()
    assert torch.equal(got[0]["stats"], got[1]["stats"])
    assert float(got[0]["stats"][0, 0]) == pytest.approx(float(want["loss"]), rel=1e-4)
    for k, v in one.state_dict().items():
        assert torch.equal(got[0]["state"][k], got[1]["state"][k]), k
        gap = (got[0]["state"][k] - v.cpu()).abs()
        assert gap.max() <= 2 * lr * (1 + 1e-3), (k, gap.max())
        if k in rms and rms[k].max() > 0:
            clear = (rms[k] > 1e-2 * rms[k].max()).cpu()
            share = float((clear & (gap > 5e-4)).sum() / clear.sum())
            assert share <= 0.01, (k, share)


@pytest.mark.gpu
def test_cuda_nccl_world_of_one_window_matches_eager(cuda, tmp_path, monkeypatch):
    """A resident window captured under an NCCL group of one (its
    statistics' and gradient's all-reduces inside the graph) against eager
    steps under the same group on the batches it gathers, as
    test_cuda_resident_windows_match_eager_steps holds them."""
    from pathtracker_torch.parallel import distributed
    from pathtracker_torch.parallel.mesh import data_group, make_mesh

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    distributed.initialize(f"file://{tmp_path / 'store'}", 1, 0)
    try:
        with data_group(make_mesh()):
            clips, labels, models, opts, graphed, eager = _resident_pair(
                cuda, dict(lr=1e-3), 2)
            losses = []
            for _ in range(2):
                stats = graphed(clips, labels)
                for j, loss in enumerate(stats["loss"]):
                    idx = graphed.indices(len(losses))
                    want = eager(clips.index_select(0, idx), labels.index_select(0, idx))
                    losses.append((float(loss), float(want["loss"])))
        assert len(graphed.graphs) == 1
        assert all(got == want for got, want in losses), losses
        _assert_window_matches_eager(opts, models, 1e-3, len(losses))
    finally:
        distributed.shutdown()


# ----------------------- model parallel (parallel/) --------------------------

def _model_parallel_ranks(tmp_path, world, cases, backend=None):
    """``world`` ranks of tests/torch_model_parallel_worker.py on the card
    (gloo: NCCL takes one card a rank; ``backend`` None: NCCL, for a world
    of one) on ``cases``; their results."""
    import subprocess

    torch.save(cases, tmp_path / "in.pt")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_model_parallel_worker.py")
    procs, logs = [], []
    for rank in range(world):
        logs.append(open(tmp_path / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(rank), str(world), str(tmp_path / "store"),
             str(tmp_path / "in.pt"), str(tmp_path / f"out{rank}.pt"), "cuda",
             *([backend] if backend else [])],
            stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{rank}.log").read_text()[-4000:]
    return [torch.load(tmp_path / f"out{rank}.pt") for rank in range(world)]


@pytest.mark.gpu
def test_cuda_gloo_collectives_of_the_model_parallel_modes(cuda, tmp_path):
    """parallel.collectives over two gloo ranks on the card's tensors, f32
    and bf16 (gloo's send and receive refuse the card's tensors: a shift
    all-gathers there): exact."""
    got = _model_parallel_ranks(tmp_path, 2, {"c": dict(kind="collectives")}, "gloo")
    for tag, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        xs = [(torch.arange(24, dtype=torch.float32).view(4, 6) + 100 * r).to(dtype)
              for r in range(2)]
        total = xs[0] + xs[1]
        for r, out in enumerate(got):
            out = out["c"]
            assert torch.equal(out[f"gather0-{tag}"], torch.cat(xs, 0))
            assert torch.equal(out[f"gather1-{tag}"], torch.cat(xs, 1))
            assert torch.equal(out[f"scatter0-{tag}"], total.chunk(2, 0)[r])
            assert torch.equal(out[f"scatter1-{tag}"], total.chunk(2, 1)[r])
            assert torch.equal(out[f"shift+1-{tag}"], xs[1 - r])
            assert torch.equal(out[f"shift-1-{tag}"], xs[1 - r])
            assert torch.equal(out[f"broadcast-{tag}"], xs[1])
            # 2 rows above and 1 below each rank's 4 rows (zeros past the ends)
            whole = torch.cat([torch.zeros(2, 6, dtype=dtype), *xs, torch.zeros(1, 6, dtype=dtype)])
            assert torch.equal(out[f"halo-{tag}"][0, 0], whole[4 * r:4 * r + 7])
        # the halo's gradient: each row's cotangents from every rank that read it
        ws = [torch.linspace(-1, 1, 42).view(7, 6).to(dtype) for _ in range(2)]
        whole = torch.zeros(11, 6, dtype=torch.float32)
        for r in range(2):
            whole[4 * r:4 * r + 7] += ws[r].float()
        for r, out in enumerate(got):
            want = whole[2 + 4 * r:6 + 4 * r].to(dtype)
            assert torch.allclose(out["c"][f"halo_grad-{tag}"][0, 0].float(), want.float(),
                                  atol=1e-2 if dtype == torch.bfloat16 else 0)


@pytest.mark.gpu
def test_cuda_fsdp_tp_sp_meshes_of_one_over_nccl_are_bit_equal_to_no_group(cuda, tmp_path):
    """One step of the fused bf16 InT (the K1-K3 kernels) under FSDP, TP and
    SP meshes of one rank over NCCL, against the same step with no group:
    bit-equal losses and weights."""
    import numpy as np

    model = dict(dimensions=C, timesteps=4, kernel_size=3, dtype="bfloat16")
    state = {k: v.cpu() for k, v in InT(seed=0, device=cuda, **model).state_dict().items()}
    rng = np.random.default_rng(0)
    case = dict(kind="world1", model="InT", kwargs=model, state=state, lr=1e-3,
                clips=torch.from_numpy(rng.integers(0, 256, (4, 4, 32, 32, 3), dtype=np.uint8)),
                labels=torch.from_numpy(rng.integers(0, 2, (4,), dtype=np.uint8)))
    got = _model_parallel_ranks(tmp_path, 1, {"w": case})[0]["w"]
    for mode in ("fsdp", "tp", "sp"):
        assert torch.equal(got[mode]["stats"], got["none"]["stats"]), mode
        for k, v in got["none"]["state"].items():
            assert torch.equal(got[mode]["state"][k], v), (mode, k)
        assert (got[mode]["launches"] == torch.tensor([8, 8, 8, 4, 4, 4])).all(), mode


@pytest.mark.gpu
def test_cuda_k1_k3_run_on_a_space_ranks_rows(cuda, tmp_path, monkeypatch):
    """dp x sp as 1 x 2 on the card: each gloo rank runs the six K1-K3
    kernels on its rows of H (16 of 32), and the step's loss is bit-equal to
    one process computing the batch as the ranks do
    (``chip_smoke._as_space_ranks``) under cudnn.deterministic."""
    import numpy as np

    from pathtracker_torch.train.steps import make_optimizer, make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = dict(dimensions=C, timesteps=4, kernel_size=3, dtype="bfloat16")
    state = {k: v.cpu() for k, v in InT(seed=0, device=cuda, **model).state_dict().items()}
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.integers(0, 256, (4, 4, 32, 32, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 2, (4,), dtype=np.uint8))
    ranks = _model_parallel_ranks(tmp_path, 2, {"sp": dict(
        kind="step", model="InT", kwargs=model, state=state, lr=1e-3, mode="sp", mesh=(1, 2),
        clips=clips, labels=labels)}, "gloo")
    for r in ranks:
        assert (r["sp"]["launches"] == torch.tensor([8, 8, 8, 4, 4, 4])).all()
        assert torch.equal(r["sp"]["stats"], ranks[0]["sp"]["stats"])
    one = InT(device=cuda, **model)
    one.load_state_dict(state)
    with chip_smoke._as_space_ranks(2, 32):
        want = make_train_step(one, "InT", make_optimizer(1e-3))(clips.to(cuda), labels.to(cuda))
    assert float(ranks[0]["sp"]["stats"][0]) == float(want["loss"])
