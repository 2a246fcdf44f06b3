"""The port's attribution viz and greedy tracker against pathtracker_tpu's:
greedy answers and the CLI bit-equal on a rendered shard (as
tests/test_tfrecord.py:316), ``load_human_responses`` in each of its three
cases, the attribution step against ``jax.grad`` through the JAX engine on
shared weights (f32: atol 1e-3 / rtol 5e-3 for outputs, states and gates,
the 5-step tolerance of tests/test_int_parity.py:93; the saliency maps,
each normalised by its largest entry, to atol 1e-3, as the gradients of
tests/test_torch_int_grad.py), and both ``main``s on the same shard: the
npz's keys and shapes, its arrays at the same tolerances, the printout's
accuracies exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracker_torch.data import pathtracker as tdata
from pathtracker_torch.data import registry as tregistry
from pathtracker_torch.data.tfrecord import read_clip_records
from pathtracker_torch.eval import greedy as tgreedy
from pathtracker_torch.eval import viz as tviz
from pathtracker_torch.models.int_circuit import InT
from pathtracker_torch.train.torch_import import state_dict_from_jax
from pathtracker_torch.utils.opts import parser as tparser
from pathtracker_tpu import engine as jengine
from pathtracker_tpu.data import registry as jregistry
from pathtracker_tpu.data.prepare import prepare_batch as jprepare
from pathtracker_tpu.eval import greedy as jgreedy
from pathtracker_tpu.eval import viz as jviz
from pathtracker_tpu.train import checkpoint as jckpt
from pathtracker_tpu.train.loop import init_model
from pathtracker_tpu.utils.opts import parser as jparser

T, DIMS, K, BATCH = 8, 8, 3, 4
SET = "gen_1_1_8"  # a human-experiment set at a test's size: dist 1, T=8
ATOL, RTOL = 1e-3, 5e-3


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("greedy")
    root = tdata.make_synthetic_dataset(str(tmp), n_train=2, n_test=24, timesteps=12,
                                        n_distractors=1, shards=2)
    return os.path.join(root, "test-*")


def test_greedy_answers_are_bit_equal_to_jax(shard):
    import glob

    n = 0
    for path in sorted(glob.glob(shard)):
        for clip, _ in read_clip_records(path):
            for radius in (1.0, 2.5):
                assert tgreedy.greedy_track(clip, radius) == jgreedy.greedy_track(clip, radius)
            assert tgreedy.greedy_response(clip) == jgreedy.greedy_response(clip)
            n += 1
    assert n == 24
    for t, count in ((12, 24), (12, 5)):
        np.testing.assert_array_equal(tgreedy.greedy_responses_for_shards(shard, t, count),
                                      jgreedy.greedy_responses_for_shards(shard, t, count))
    records = list(read_clip_records(sorted(glob.glob(shard))[0]))
    assert (tgreedy.greedy_accuracy_over_records(records, n=7)
            == jgreedy.greedy_accuracy_over_records(records, n=7))
    with pytest.raises(ValueError, match="no records"):
        tgreedy.greedy_accuracy_over_records([])


def test_greedy_cli_prints_as_jax(shard, capsys, monkeypatch):
    out = {}
    for name, module in (("torch", tgreedy), ("jax", jgreedy)):
        monkeypatch.setattr("sys.argv", ["greedy", "--glob", shard, "--n", "20"])
        module._main()
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"] and "over 20 clips" in out["torch"]
    monkeypatch.setattr("sys.argv", ["greedy", "--glob", shard + "-none"])
    with pytest.raises(SystemExit, match="no shards"):
        tgreedy._main()


def test_load_human_responses_in_each_case(shard, tmp_path, capsys):
    asset = tmp_path / "mturk"
    asset.mkdir()
    want = np.linspace(0.1, 0.9, 24).astype(np.float32)
    np.save(asset / "gen_x_average_responses.npy", want)
    for kw in (dict(responses_dir=str(asset)),  # the MTurk asset
               dict(responses_dir=str(tmp_path), shard_pattern=shard, timesteps=12),
               dict(responses_dir=str(tmp_path))):  # seeded placeholders
        got = tviz.load_human_responses("gen_x", 24, **kw)
        ref = jviz.load_human_responses("gen_x", 24, **kw)
        assert got.dtype == ref.dtype and got.shape == ref.shape == (24,)
        np.testing.assert_array_equal(got, ref)
        printed = capsys.readouterr().out
        assert printed.count("WARNING") == (0 if kw.get("responses_dir") == str(asset) else 2)
    np.testing.assert_array_equal(tviz.load_human_responses("gen_x", 24, str(asset)), want)


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    """A human-experiment set rendered at a test's size and a checkpoint of
    the JAX package's seeded init, its readout bias raised so that every
    clip scores positive: the positive clips are then the correct ones the
    npz keeps."""
    tmp = tmp_path_factory.mktemp("viz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATHTRACKER_DATA_ROOT", str(tmp / "data"))
        for reg in (tregistry, jregistry):
            mp.setitem(reg.HUMAN_DATASETS, SET, {"dist": 1, "speed": 1, "length": T})
        tregistry.dataset_selector(1, 1, T, synth_train=BATCH, synth_test=2 * BATCH)
        args = jparser.parse_args(["--model", "InT", "--name", "tiny", "--set_name", SET,
                                   "--length", str(T), "-b", str(BATCH), "-d", str(DIMS),
                                   "-k", str(K)])
        _, variables = init_model(args, T)
        params = {n: np.asarray(v) for n, v in variables["params"].items()}
        params["readout_dense_bias"] = params["readout_dense_bias"] + 50.0
        path = str(tmp / "init.pth.tar")
        jckpt.save_checkpoint(path, params)
        yield tmp, path, params, mp


def _jax_attribution(params, raw_imgs, raw_labels, hp):
    """viz.py:78-93's attribution_step, un-jitted, on the JAX model."""
    model = InT_jax()
    imgs, target = jprepare(jnp.asarray(raw_imgs), jnp.asarray(raw_labels))

    def score_fn(im):
        output, states, gates = jengine.model_step(model, {"params": params}, im, "InT",
                                                   test=True)
        human_logit = jnp.log(hp) - jnp.log1p(-hp)
        return jnp.mean((output.reshape(-1) - human_logit) ** 2), (output, states, gates)

    grads, (output, states, gates) = jax.grad(score_fn, has_aux=True)(imgs)
    return output, states, gates, jax.nn.relu(grads), jax.nn.relu(-grads), imgs, target


def InT_jax():
    from pathtracker_tpu.models.int_circuit import InT as JInT
    return JInT(dimensions=DIMS, timesteps=T, kernel_size=K)


def _saliency_close(got, want, what):
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=ATOL, err_msg=what)


def test_attribution_step_matches_jax(tiny_set):
    _, _, params, _ = tiny_set
    model = InT(dimensions=DIMS, timesteps=T, kernel_size=K, device="cpu")
    model.load_state_dict(state_dict_from_jax("InT", params))
    for p in model.parameters():
        p.requires_grad_(False)
    clips = tdata.render_batch(3, BATCH, T, n_distractors=1)
    raw, labels = clips
    hp = np.clip(np.random.default_rng(0).uniform(0.05, 0.95, BATCH), 1e-4,
                 1 - 1e-4).astype(np.float32)
    got = tviz.attribution_step(model, "InT", raw, labels, hp)
    want = _jax_attribution(params, raw, labels, jnp.asarray(hp))
    names = ("output", "states", "gates", "pos_grads", "neg_grads", "imgs", "target")
    for g, w, what in zip(got, want, names):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, what
        if what.endswith("grads"):
            assert np.abs(w).max() > 0, what
            _saliency_close(g, w, what)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=what)
    assert (got[3] * got[4]).abs().max() == 0  # positive and negative parts apart
    assert not any(p.grad is not None for p in model.parameters())


def test_main_writes_the_npz_as_jax(tiny_set, tmp_path, monkeypatch, capsys):
    tmp, path, _, _ = tiny_set
    monkeypatch.setenv("PATHTRACKER_DATA_ROOT", str(tmp / "data"))
    for reg in (tregistry, jregistry):
        monkeypatch.setitem(reg.HUMAN_DATASETS, SET, {"dist": 1, "speed": 1, "length": T})
    argv = ["--model", "InT", "--name", "tiny", "--set_name", SET, "--length", str(T),
            "-b", str(BATCH), "-d", str(DIMS), "-k", str(K), "--ckpt", path]
    out = {}
    for name, module, p in (("torch", tviz, tparser), ("jax", jviz, jparser)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        args = p.parse_args(argv)
        if name == "torch":
            args.device = "cpu"
        accs = module.main(args)
        printed = capsys.readouterr().out
        out[name] = (accs, printed.splitlines()[-1],
                     dict(np.load(os.path.join("results", "tiny",
                                               f"mturk_visualizations_{SET}.npz"))))
    (accs, line, npz), (jaccs, jline, jnpz) = out["torch"], out["jax"]
    assert accs == jaccs and line == jline and line.startswith("Model accuracy: ")
    assert sorted(npz) == sorted(jnpz) == sorted(
        ["attention", "states", "pos_grads", "neg_grads", "imgs", "targets", "outputs",
         "human"])
    kept = int((npz["targets"] == 1).sum())
    assert kept > 0 and len(npz["targets"]) == kept
    for key in jnpz:
        assert npz[key].shape == jnpz[key].shape and npz[key].dtype == jnpz[key].dtype, key
        if key.endswith("grads"):
            _saliency_close(npz[key], jnpz[key], key)
        elif key in ("targets", "human"):
            np.testing.assert_array_equal(npz[key], jnpz[key], err_msg=key)
        else:
            np.testing.assert_allclose(npz[key], jnpz[key], atol=ATOL, rtol=RTOL, err_msg=key)
    assert npz["attention"].shape == (kept, T, DIMS, 32, 32)
    assert npz["states"].shape == (kept, T, 1, 32, 32)
    assert npz["imgs"].shape == (kept, 3, T, 32, 32)


def test_attribution_reaches_the_recomputed_fused_step_through_the_clips_alone(monkeypatch):
    """With every parameter frozen, the clips' requires_grad alone sends the
    fused cell through ``_RecomputedStep`` (one a frame), and K1's backward
    runs without the attention map's cotangent: the maps are only read out."""
    from pathtracker_torch.models import int_circuit
    from pathtracker_torch.ops import int_fused as F

    t = 2
    model = InT(dimensions=32, timesteps=t, kernel_size=3, dtype="bfloat16", device="cpu")
    assert model.use_fused
    for p in model.parameters():
        p.requires_grad_(False)
    steps, datts = [], []
    apply = int_circuit._RecomputedStep.apply
    monkeypatch.setattr(int_circuit._RecomputedStep, "apply",
                        lambda *a: steps.append(1) or apply(*a))
    bwd = F.k1_attention_bwd

    def recording_bwd(exc, att_x, a_u, a_u_b, dgated, datt=None):
        datts.append(datt)
        return bwd(exc, att_x, a_u, a_u_b, dgated, datt)

    monkeypatch.setattr(F, "k1_attention_bwd", recording_bwd)
    raw, labels = tdata.render_batch(4, 2, t, n_distractors=1)
    out = tviz.attribution_step(model, "InT", raw[:, :, :8, :8], labels,
                                np.full(2, 0.6, np.float32))
    assert len(steps) == t and len(datts) == t and all(d is None for d in datts)
    assert float(out[3].max()) > 0 and bool(torch.isfinite(out[3]).all())
