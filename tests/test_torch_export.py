"""The port's serving export (eval/serve.py: torch.export with a symbolic
batch, .pt2 round trips, the CLI), following tests/test_export.py:34-100,
and the K1-K3 forward custom ops it records.

Every comparison is exact (atol 0): the loaded program runs the same ATen
ops and custom ops on the same inputs as the live model. The fused cases
run InT at 32 channels under --bf16, where the CPU's custom ops take the
kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from pathtracker_torch.eval import serve
from pathtracker_torch.ops import int_fused as F
from pathtracker_torch.train import checkpoint as tckpt

T, HW = 3, 12


def _frames(batch, seed=0, hw=HW):
    return np.random.default_rng(seed).integers(0, 255, (batch, T, hw, hw, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def fused():
    model = serve.build(length=T, bf16=True, fb_kernel_size=3, device="cpu")
    assert model.use_fused
    return model


def _custom_ops(program):
    return sorted({str(n.target) for n in program.graph.nodes
                   if str(n.target).startswith("pathtracker.")})


def test_symbolic_batch_round_trip(fused, tmp_path):
    program = serve.export_program(fused, "InT", T, height=HW, width=HW)
    assert _custom_ops(program) == ["pathtracker.k1_attention.default",
                                    "pathtracker.k2_inhibition.default",
                                    "pathtracker.k3_excitation.default"]
    assert not any(n.target is torch.ops.aten._assert_tensor_metadata.default
                   for n in program.graph.nodes)  # dropped: a host call each
    path = str(tmp_path / "int.pt2")
    serve.save_exported(program, path)
    served = serve.load_exported(path)
    live = serve.make_inference_fn(fused, "InT")
    for batch in (2, 5, 1):  # one program, several batch sizes
        x = _frames(batch, seed=batch)
        got, want = served(x), live(x)
        assert got.shape == (batch,) and got.dtype == torch.float32
        assert torch.equal(got, want)
        assert bool(((got >= 0) & (got <= 1)).all())


def test_static_batch_pins_the_shape(fused, tmp_path):
    program = serve.export_program(fused, "InT", T, batch=2, probs=False,
                                   height=HW, width=HW)
    path = str(tmp_path / "int2.pt2")
    serve.save_exported(program, path)
    served = serve.load_exported(path)
    x = _frames(2)
    assert torch.equal(served(x), serve.make_inference_fn(fused, "InT", probs=False)(x))
    with pytest.raises(Exception):
        served(_frames(3))  # a wrong batch is rejected, not miscomputed


def test_second_family_gru(tmp_path):
    model = serve.build(model="gru", length=T, dimensions=4, fb_kernel_size=3,
                        device="cpu")
    path = str(tmp_path / "gru.pt2")
    serve.save_exported(serve.export_program(model, "gru", T, height=HW, width=HW), path)
    x = _frames(3, seed=3)
    assert torch.equal(serve.load_exported(path)(x),
                       serve.make_inference_fn(model, "gru")(x))


def test_cli_from_a_checkpoint(tmp_path, capsys):
    model = serve.build(length=T, dimensions=8, fb_kernel_size=3, device="cpu")
    ckpt = str(tmp_path / "model_val_acc_0050_epoch_01_checkpoint.pth.tar")
    tckpt.save_checkpoint(ckpt, model.state_dict(), epoch=1, acc=0.5)
    out = tmp_path / "int.pt2"
    serve.main(["--model", "InT", "--length", str(T), "-d", "8", "-k", "3",
                "--ckpt", ckpt, "--out", str(out), "--selftest-batch", "3",
                "--platforms", "cpu,tpu", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "bytes, batch=symbolic" in printed and "selftest ok" in printed
    x = _frames(4, seed=9, hw=32)
    assert torch.equal(serve.load_exported(str(out))(x),
                       serve.make_inference_fn(model, "InT")(x))
    assert "there is no platform to choose" in serve_help()


def serve_help():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        serve.main(["--help"])
    return " ".join(buf.getvalue().split())


def _k_args(rows=40, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    bf, c = torch.bfloat16, F.C
    k1 = (r(rows, c), r(rows, c, dtype=bf), r(c, c, dtype=bf), r(c))
    k2 = (r(rows, c, dtype=bf), r(c), r(c).abs(), r(c), r(c), r(rows, c, dtype=bf),
          r(rows, c, dtype=bf), r(rows, c), r(c, c, dtype=bf), r(c), r(c), r(c))
    k3 = (r(rows, c, dtype=bf), r(c), r(c).abs(), r(c), r(c), r(rows, c), r(rows, c),
          r(rows, c, dtype=bf), r(rows, c), r(c, c, dtype=bf), r(c), r(c, c, dtype=bf),
          r(c), r(c), r(c))
    return {"k1_attention": k1, "k2_inhibition": k2, "k3_excitation": k3}


@pytest.mark.parametrize("name", ["k1_attention", "k2_inhibition", "k3_excitation"])
def test_custom_ops_fake_and_real_agree(name):
    """The fake implementation gives the real outputs' shapes and dtypes; on
    CPU tensors the real one is the plain version and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = getattr(torch.ops.pathtracker, name)
    args = _k_args()[name]
    before = [k.launches for k in F.KERNELS]
    real = op(*args)
    assert [k.launches for k in F.KERNELS] == before
    plain = getattr(F, f"{name}_plain")(*args)
    real, plain = (x if isinstance(x, tuple) else (x,) for x in (real, plain))
    for a, b in zip(real, plain):
        assert torch.equal(a, b)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) for a in args))
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fake] == [(a.shape, a.dtype) for a in real]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    with pytest.raises(ValueError, match="expected"):
        op(*(args[0][:, :8],) + args[1:])  # the checks run in the real op
