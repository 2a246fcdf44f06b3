"""The fused InT cell phases: pathtracker_torch.ops.int_fused against the
Pallas kernels of pathtracker_tpu.ops.int_fused (interpret mode on the CPU).

The JAX kernels take the packed [R*C/128, 128] view, block-diagonal gate
matrices and lane-tiled vectors of the same arrays; a packed view is a plain
reshape of row-major [R, C], so outputs compare after a reshape.
Tolerances: f32 outputs atol 1e-5; bf16 outputs within one bf16 ulp (f32
sums in another order may land on the other side of a rounding boundary).

The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.ops import _native
from pathtracker_torch.ops import int_fused as T
from pathtracker_tpu.ops import int_fused as J

C = 32
BF16 = torch.bfloat16


def _assert_bf16_ulp(ours, theirs):
    ours, theirs = np.asarray(ours, np.float32), np.asarray(theirs, np.float32)
    ulp = np.spacing(np.maximum(np.abs(ours), np.abs(theirs))) * 2.0 ** 16
    assert np.all(np.abs(ours - theirs) <= ulp), np.abs(ours - theirs).max()


def _inputs(rows, seed=0):
    """Seeded numpy inputs in the ranges the cell produces: softplus-range
    states, O(1) projections and conv outputs, orthogonal-scale gates."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, pos=False):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return np.log1p(np.exp(x)).astype(np.float32) if pos else x

    def bf(x):
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    return dict(
        exc=r(rows, C, pos=True), inh=r(rows, C, pos=True),
        new_inh=r(rows, C, pos=True),
        att_x=bf(r(rows, C)), inp=bf(r(rows, C, pos=True)), gi_x=bf(r(rows, C)),
        conv_i=bf(r(rows, C, scale=2.0)), conv_e=bf(r(rows, C, scale=2.0)),
        gated=bf(r(rows, C, pos=True)),
        a_u=bf(r(C, C, scale=C ** -0.5)), i_u=bf(r(C, C, scale=C ** -0.5)),
        e_w=bf(r(C, C, scale=C ** -0.5)), e_u=bf(r(C, C, scale=C ** -0.5)),
        **{k: r(C, scale=0.5) for k in (
            "a_u_b", "i_u_b", "e_w_b", "e_u_b", "mean0", "mean1", "scale0",
            "bias0", "scale1", "bias1", "alpha", "mu", "kappa", "gamma")},
        rstd0=r(C, pos=True), rstd1=r(C, pos=True),
    )


_BF16_ROWS = {"att_x", "inp", "gi_x", "conv_i", "conv_e", "gated"}
_MATS = {"a_u", "i_u", "e_w", "e_u"}


def _torch(d, device="cpu"):
    out = {}
    for k, v in d.items():
        t = torch.tensor(v, device=device)
        out[k] = t.to(BF16) if k in _BF16_ROWS | _MATS else t
    return out


def _jax(d):
    out = {}
    for k, v in d.items():
        if k in _MATS:
            out[k] = J.blockdiag(jnp.asarray(v, jnp.bfloat16), C)
        elif v.ndim == 1:
            out[k] = J.tile_param(jnp.asarray(v), C)
        else:
            out[k] = J.pack(jnp.asarray(v, jnp.bfloat16 if k in _BF16_ROWS else jnp.float32))
    return out


K1_ARGS = ("exc", "att_x", "a_u", "a_u_b")
K2_ARGS = ("conv_i", "mean0", "rstd0", "scale0", "bias0", "inp", "gi_x", "inh",
           "i_u", "i_u_b", "alpha", "mu")
K3_ARGS = ("conv_e", "mean1", "rstd1", "scale1", "bias1", "new_inh", "inh",
           "gated", "exc", "e_w", "e_w_b", "e_u", "e_u_b", "kappa", "gamma")


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)).reshape(-1, C)


def test_k1_plain_matches_pallas():
    d = _inputs(1024)
    t, j = _torch(d), _jax(d)
    gated, att = T.k1_attention_plain(*(t[k] for k in K1_ARGS))
    jg, ja = J.k1_attention(*(j[k] for k in K1_ARGS))
    assert gated.dtype == BF16 and att.dtype == torch.float32
    np.testing.assert_allclose(att.numpy(), _f32(ja), rtol=0, atol=1e-5)
    _assert_bf16_ulp(gated.float().numpy(), _f32(jg))


def test_k2_plain_matches_pallas():
    d = _inputs(1024, seed=1)
    t, j = _torch(d), _jax(d)
    ours = T.k2_inhibition_plain(*(t[k] for k in K2_ARGS))
    theirs = J.k2_inhibition(*(j[k] for k in K2_ARGS))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), _f32(theirs), rtol=0, atol=1e-5)


def test_k3_plain_matches_pallas():
    d = _inputs(1024, seed=2)
    t, j = _torch(d), _jax(d)
    ours = T.k3_excitation_plain(*(t[k] for k in K3_ARGS))
    theirs = J.k3_excitation(*(j[k] for k in K3_ARGS))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), _f32(theirs), rtol=0, atol=1e-5)


def test_stats_matches_packed_stats():
    x = _inputs(1024, seed=3)["conv_i"]
    mean, rstd = T.stats(torch.tensor(x).to(BF16))
    jm, jr = J.packed_stats(J.pack(jnp.asarray(x, jnp.bfloat16)), C)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm)[0, :C], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jr)[0, :C], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wrapper,plain,names", [
    (T.k1_attention, T.k1_attention_plain, K1_ARGS),
    (T.k2_inhibition, T.k2_inhibition_plain, K2_ARGS),
    (T.k3_excitation, T.k3_excitation_plain, K3_ARGS),
])
def test_wrapper_checks_and_takes_plain_on_cpu(wrapper, plain, names):
    t = _torch(_inputs(100, seed=4))  # a ragged row count is taken
    args = [t[k] for k in names]
    before = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)
    assert wrapper.launches == before  # the plain version is no launch

    bad_dtype = list(args)
    bad_dtype[0] = args[0].double()
    with pytest.raises(ValueError, match="expected"):
        wrapper(*bad_dtype)
    strided = list(args)
    strided[0] = torch.cat([args[0], args[0]], dim=1)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(*strided)
    wide = [torch.zeros(a.shape[0], 24, dtype=a.dtype) if a.dim() == 2
            and a.shape[0] == 100 else a for a in args]
    with pytest.raises(ValueError, match="expected"):
        wrapper(*wide)
    # An input that requires grad goes through the autograd.Function: same
    # values, and a gradient comes back (tests/test_torch_kernels_bwd.py
    # holds it against the plain backward).
    grad = list(args)
    state = names.index("exc" if "exc" in names else "inh")
    grad[state] = args[state].clone().requires_grad_()
    out = wrapper(*grad)
    out = out if isinstance(out, tuple) else (out,)
    for a, b in zip(out, want if isinstance(want, tuple) else (want,)):
        assert a.requires_grad and torch.equal(a, b)
    (dstate,) = torch.autograd.grad(out[-1].sum(), [grad[state]])
    assert dstate.shape == args[state].shape and torch.isfinite(dstate).all()


def _exported_functions(source):
    """{name: (pointer parameters, ``long long`` parameters)} of the ``int``
    functions that ``csrc/<source>.cu`` defines in its ``extern "C"`` block."""
    text = (_native.CSRC / f"{source}.cu").read_text()
    block = text[text.index('extern "C" {'):text.rindex('}  // extern "C"')]
    found = {}
    for name, params in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", block, flags=re.M):
        params = [" ".join(p.split()) for p in params.split(",")]
        pointers = [p for p in params if re.fullmatch(r"(const )?void\* \w+", p)]
        integers = [p for p in params if re.fullmatch(r"long long \w+", p)]
        assert len(pointers) + len(integers) == len(params), (name, params)
        found[name] = (pointers, integers)
    return found


@pytest.mark.parametrize("source", sorted(_native.SIGNATURES))
def test_signatures_match_the_exported_c_functions(source):
    """``ctypes`` passes whatever it is given: a miscounted pointer would
    reach the kernel as garbage without an error. Every kernel function takes
    its tensor pointers, its integers, then the stream; a ``<fn>_blocks``
    query takes the row count alone."""
    exported = _exported_functions(source)
    queries = {n for n in exported if n.endswith("_blocks")}
    assert set(exported) - queries == set(_native.SIGNATURES[source])
    for fn, (n_ptrs, n_ints) in _native.SIGNATURES[source].items():
        pointers, integers = exported[fn]
        assert pointers[-1] == "void* stream", fn
        assert (len(pointers) - 1, len(integers)) == (n_ptrs, n_ints), fn
    # Every backward kernel sizes its partial-sum workspace by its query.
    assert queries == {fn + "_blocks" for fn in _native.SIGNATURES[source]
                       if fn.endswith("_bwd")}
    for query in queries:
        assert exported[query] == ([], ["long long rows"])


def test_library_hash_covers_the_included_headers(tmp_path, monkeypatch):
    """An edited header builds anew every library whose source includes it,
    and no other: the hash covers the source and its ``csrc/`` headers."""
    for f in _native.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    assert _native.included_headers("int_cell") == ["ring.cuh"]
    assert _native.included_headers("int_cell_bwd") == ["ring.cuh"]
    assert _native.included_headers("correlation") == []
    before = {name: _native.library_path(name) for name in _native.SIGNATURES}
    header = tmp_path / "ring.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {name: _native.library_path(name) for name in _native.SIGNATURES}
    for name in _native.SIGNATURES:
        changed = before[name] != after[name]
        assert changed == ("ring.cuh" in _native.included_headers(name)), name
        assert after[name].name.startswith(f"lib{name}_")


def test_supported_and_build_need_the_toolkit(monkeypatch):
    assert T.supported(32) and not T.supported(24) and not T.supported(64)
    assert _native.library_path("int_cell").name.startswith("libint_cell_")
    assert set(_native.SIGNATURES["int_cell"]) == {
        "k1_attention_fwd", "k2_inhibition_fwd", "k3_excitation_fwd"}
    assert set(_native.SIGNATURES["int_cell_bwd"]) == {
        "k1_attention_bwd", "k2_inhibition_bwd", "k3_excitation_bwd"}
    assert _native.library_path("int_cell_bwd").name.startswith("libint_cell_bwd_")
    assert [k.__name__ for k in T.KERNELS] == [
        "k1_attention", "k2_inhibition", "k3_excitation",
        "k1_attention_bwd", "k2_inhibition_bwd", "k3_excitation_bwd"]
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_native, "library_path",
                        lambda name: _native.BUILD / "never-built.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build()
