"""SIFID of the port (``hpvaegan_tpu_torch/eval/_sifid.py``) against the
JAX package's (``hpvaegan_tpu/eval/_sifid.py``) on the CPU, on the same
numpy-seeded images and the same weights: the random stem (drawn
bit-equal by both) or a synthetic torchvision state dict, whose
BatchNorm both fold in float64.

Tolerances: stem features at the f32 bar rtol 2e-3 / atol 2e-4; the
float64 statistics rtol 1e-4; SIFID end to end rtol 1e-4; the folded
weights bit-equal (both fold in float64, then round to f32)."""
import logging

import numpy as np
import pytest
import torch

import hpvaegan_tpu.eval as je
from hpvaegan_tpu.eval import _sifid as jf
import hpvaegan_tpu_torch.eval as pe
from hpvaegan_tpu_torch.eval import _sifid as pf

RTOL, ATOL = 2e-3, 2e-4
STATS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(seed, shape=(40, 37, 3)):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("tap", pf.SIFID_TAPS)
def test_stem_forward_equals_flax(tap):
    params = pf.random_stem_params(tap, 1)
    x = _image(1, (2, 24, 29, 3))
    want = np.asarray(jf.InceptionStem(tap=tap).apply(params, x))
    model = pf.build_stem(params, tap, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("tap", ["Conv2d_2a_3x3", "pool1"])
def test_feature_stats_equal_jax(tap):
    x = _image(2)
    mu, cov = pf.image_feature_stats(pf.random_stem_params(tap, 2), x, tap,
                                     device="cpu")
    mu_j, cov_j = jf.image_feature_stats(jf.random_stem_params(tap, 2), x,
                                         tap)
    assert mu.dtype == cov.dtype == np.float64
    np.testing.assert_allclose(mu, mu_j, rtol=STATS_RTOL,
                               atol=STATS_RTOL * np.abs(mu_j).max())
    np.testing.assert_allclose(cov, cov_j, rtol=STATS_RTOL,
                               atol=STATS_RTOL * np.abs(cov_j).max())


@pytest.mark.parametrize("tap,seed", [("pool1", 0), ("Conv2d_2b_3x3", 3)])
def test_sifid_equals_jax(tap, seed, caplog):
    real = _image(4)
    fakes = [_image(5), _image(6), real.copy()]
    caplog.set_level(logging.WARNING)
    got = pe.sifid(real, fakes, tap=tap, seed=seed, device="cpu")
    assert any("RANDOM stem" in r.getMessage() for r in caplog.records)
    want = je.sifid(real, fakes, tap=tap, seed=seed)
    assert got["pretrained"] is want["pretrained"] is False
    assert got["tap"] == want["tap"] == tap
    np.testing.assert_allclose(got["per_sample"][:2], want["per_sample"][:2],
                               rtol=STATS_RTOL)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=STATS_RTOL)
    assert abs(got["per_sample"][2]) < 1e-3 * min(got["per_sample"][:2])


def _inception_state(prefix=""):
    rng = np.random.default_rng(8)
    state, in_ch = {}, 3
    for name, features, _, _ in jf.STEM_LAYERS:
        p = f"{prefix}{name}"
        state[f"{p}.conv.weight"] = torch.from_numpy(rng.standard_normal(
            (features, in_ch, 3, 3)).astype(np.float32) * 0.2)
        state[f"{p}.bn.weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, features).astype(np.float32))
        state[f"{p}.bn.bias"] = torch.from_numpy(
            rng.standard_normal(features).astype(np.float32) * 0.1)
        state[f"{p}.bn.running_mean"] = torch.from_numpy(
            rng.standard_normal(features).astype(np.float32) * 0.1)
        state[f"{p}.bn.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, features).astype(np.float32))
        in_ch = features
    state[f"{prefix}fc.weight"] = torch.zeros(2, 2)
    return state


@pytest.mark.parametrize("prefix", ["", "module."])
def test_batchnorm_fold_equals_jax(tmp_path, prefix, monkeypatch):
    path = str(tmp_path / "inception.pth")
    torch.save(_inception_state(prefix), path)
    monkeypatch.delenv("INCEPTION_WEIGHTS_SHA256", raising=False)
    got = pf.load_inception_torch(path, "pool1")["params"]
    want = jf.load_inception_torch(path, "pool1")["params"]
    assert sorted(got) == sorted(want)
    for name in want:
        for leaf in ("kernel", "bias"):
            assert got[name][leaf].dtype == np.float32
            np.testing.assert_array_equal(got[name][leaf],
                                          np.asarray(want[name][leaf]))
    # the fold is eval-mode BatchNorm after the bias-free conv
    state = _inception_state()
    x = torch.from_numpy(_image(3, (1, 20, 20, 3))).movedim(-1, 1)
    name = "Conv2d_1a_3x3"
    conv = torch.nn.functional.conv2d(x.double(),
                                      state[f"{name}.conv.weight"].double(),
                                      stride=2)
    bn = {k: state[f"{name}.bn.{k}"].double()
          for k in ("weight", "bias", "running_mean", "running_var")}
    ref = torch.nn.functional.batch_norm(
        conv, bn["running_mean"], bn["running_var"], bn["weight"],
        bn["bias"], training=False, eps=1e-3)
    stem = pf.build_stem({"params": {name: got[name]}}, name, device="cpu")
    with torch.no_grad():
        out = stem.Conv2d_1a_3x3(x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    real = _image(9)
    np.testing.assert_allclose(
        pe.sifid(real, [_image(10)], weights_path=path,
                 device="cpu")["mean"],
        je.sifid(real, [_image(10)], weights_path=path)["mean"],
        rtol=STATS_RTOL)


def test_load_inception_torch_checks(tmp_path, monkeypatch):
    path = str(tmp_path / "inception.pth")
    state = _inception_state()
    del state["Conv2d_2a_3x3.conv.weight"]
    torch.save(state, path)
    assert sorted(pf.load_inception_torch(path, "Conv2d_1a_3x3")["params"]
                  ) == ["Conv2d_1a_3x3"]
    with pytest.raises(KeyError, match="Conv2d_2a_3x3.conv.weight"):
        pf.load_inception_torch(path, "pool1")
    state = _inception_state()
    state["Conv2d_1a_3x3.conv.weight"] = torch.zeros(32, 3, 5, 5)
    torch.save(state, path)
    with pytest.raises(ValueError, match="not a torchvision inception_v3"):
        pf.load_inception_torch(path, "pool1")
    monkeypatch.setenv("INCEPTION_WEIGHTS_SHA256", "f" * 64)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        pf.load_inception_torch(path, "pool1")


@pytest.mark.parametrize("tap", pf.SIFID_TAPS)
def test_too_small_image_raises(tap):
    n = pf._tap_min_hw(tap)
    assert n == jf._tap_min_hw(tap)
    params = pf.random_stem_params(tap)
    pf.image_feature_stats(params, np.zeros((n + 1, n + 1, 3)), tap,
                           device="cpu")
    with pytest.raises(ValueError, match="too small for SIFID tap"):
        pf.image_feature_stats(params, np.zeros((n - 1, n + 4, 3)), tap,
                               device="cpu")


def test_unknown_tap_raises():
    with pytest.raises(ValueError, match="unknown SIFID tap"):
        pf.InceptionStem("Mixed_5b")


def test_sifid_stem_is_built_once_per_key():
    pf._stem.cache_clear()
    real = _image(7)
    for _ in range(2):
        pe.sifid(real, [real], seed=4, device="cpu")
    info = pf._stem.cache_info()
    assert info.misses == 1 and info.hits == 1
