"""SVFID of the port (``hpvaegan_tpu_torch/eval/_svfid.py``, ``c3d.py``)
against the JAX package's (``hpvaegan_tpu/eval/_svfid.py``, ``c3d.py``)
on the CPU, on the same numpy-seeded clips and the same weights (the
random trunk, drawn bit-equal by both, or a synthetic state dict).

Tolerances: C3D features at the f32 bar rtol 2e-3 / atol 2e-4; the
float64 statistics of f32 features rtol 1e-4; SVFID end to end rtol
1e-4; ``frechet_distance`` (a copy, float64) rtol 1e-10."""
import logging

import numpy as np
import pytest
import torch

import hpvaegan_tpu.eval as je
from hpvaegan_tpu.eval import _svfid as js
from hpvaegan_tpu.eval import c3d as jc
import hpvaegan_tpu_torch.eval as pe
from hpvaegan_tpu_torch.eval import _svfid as ps
from hpvaegan_tpu_torch.eval import c3d as pc

RTOL, ATOL = 2e-3, 2e-4
STATS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clip(seed, shape=(4, 16, 20, 3)):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.standard_normal(shape)).astype(np.float32)


def test_preprocess_equals_jax():
    x = _clip(0)
    np.testing.assert_array_equal(
        pc.preprocess(torch.from_numpy(x)).numpy(),
        np.asarray(jc.preprocess(x)))


@pytest.mark.parametrize("layer", ["conv1", "conv2", "conv3a"])
def test_c3d_forward_equals_flax(layer):
    params = pc.random_c3d_params(layer, 2)
    x = _clip(1, (2, 4, 16, 12, 3))
    want = np.asarray(jc.C3D(feature_layer=layer).apply(
        params, jc.preprocess(x)))
    model = ps.build_c3d(params, layer, device="cpu")
    with torch.no_grad():
        got = model(pc.preprocess(torch.from_numpy(x)).movedim(-1, 1))
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("layer", ["conv1", "conv2", "conv3b"])
def test_feature_stats_equal_jax(layer):
    params = pc.random_c3d_params(layer, 2)
    x = _clip(2)
    mu, cov = ps.c3d_feature_stats(params, x, layer, device="cpu")
    mu_j, cov_j = js.c3d_feature_stats(jc.random_c3d_params(layer, 2), x,
                                       layer)
    assert mu.dtype == cov.dtype == np.float64
    scale = np.abs(cov_j).max()
    np.testing.assert_allclose(mu, mu_j, rtol=STATS_RTOL,
                               atol=STATS_RTOL * np.abs(mu_j).max())
    np.testing.assert_allclose(cov, cov_j, rtol=STATS_RTOL,
                               atol=STATS_RTOL * scale)
    # a batch of one and a bare clip are the same input
    mu1, _ = ps.c3d_feature_stats(params, x[None], layer, device="cpu")
    np.testing.assert_array_equal(mu1, mu)


def test_frechet_distance_closed_forms():
    rng = np.random.default_rng(3)
    mu1, mu2 = rng.standard_normal(6), rng.standard_normal(6)
    s1, s2 = rng.uniform(0.5, 2, 6), rng.uniform(0.5, 2, 6)
    want = (np.sum((mu1 - mu2) ** 2)
            + np.sum(s1 + s2 - 2 * np.sqrt(s1 * s2)))
    got = ps.frechet_distance(mu1, np.diag(s1), mu2, np.diag(s2))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    a = rng.standard_normal((6, 6))
    cov = a @ a.T + np.eye(6)
    assert abs(ps.frechet_distance(mu1, cov, mu1, cov)) < 1e-8
    # a singular product takes the eps * I reseed, as the JAX copy does
    sing = np.diag([1.0, 0.0, 2.0])
    got = ps.frechet_distance(np.zeros(3), sing, np.ones(3), sing)
    np.testing.assert_allclose(
        got, js.frechet_distance(np.zeros(3), sing, np.ones(3), sing),
        rtol=1e-10)
    b = rng.standard_normal((6, 6))
    cov2 = b @ b.T
    np.testing.assert_allclose(
        ps.frechet_distance(mu1, cov, mu2, cov2),
        js.frechet_distance(mu1, cov, mu2, cov2), rtol=1e-10)


@pytest.mark.parametrize("layer,seed", [("conv2", 1), ("conv3b", 0)])
def test_svfid_equals_jax(layer, seed, caplog):
    real = _clip(4)
    fakes = [_clip(5), _clip(6), real.copy()]
    caplog.set_level(logging.WARNING)
    got = pe.svfid(real, fakes, feature_layer=layer, seed=seed,
                   device="cpu")
    assert any("RANDOM C3D" in r.getMessage() for r in caplog.records)
    want = je.svfid(real, fakes, feature_layer=layer, seed=seed)
    assert got["pretrained"] is want["pretrained"] is False
    assert got["feature_layer"] == want["feature_layer"] == layer
    np.testing.assert_allclose(got["per_sample"][:2], want["per_sample"][:2],
                               rtol=STATS_RTOL)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=STATS_RTOL)
    # the real clip against itself scores ~0
    assert abs(got["per_sample"][2]) < 1e-3 * min(got["per_sample"][:2])
    assert np.isnan(pe.svfid(real, [], feature_layer=layer,
                             device="cpu")["mean"])


def test_svfid_trunk_is_built_once_per_key():
    ps._trunk.cache_clear()
    real = _clip(7)
    for _ in range(2):
        pe.svfid(real, [real], feature_layer="conv1", seed=4, device="cpu")
    info = ps._trunk.cache_info()
    assert info.misses == 1 and info.hits == 1


def _state_dict(layer, prefix=""):
    rng = np.random.default_rng(8)
    state, in_ch = {}, 3
    for name, features in jc.C3D_LAYERS:
        state[f"{prefix}{name}.weight"] = torch.from_numpy(
            rng.standard_normal((features, in_ch, 3, 3, 3)).astype(
                np.float32) * 0.05)
        state[f"{prefix}{name}.bias"] = torch.from_numpy(
            rng.standard_normal(features).astype(np.float32) * 0.1)
        in_ch = features
        if name == layer:
            break
    state[f"{prefix}fc6.weight"] = torch.zeros(4, 4)
    return state


@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_c3d_torch_equals_jax(tmp_path, prefix, monkeypatch):
    path = str(tmp_path / "c3d.pth")
    torch.save(_state_dict("conv2", prefix), path)
    monkeypatch.delenv("C3D_WEIGHTS_SHA256", raising=False)
    got = pc.load_c3d_torch(path, "conv2")["params"]
    want = jc.load_c3d_torch(path, "conv2")["params"]
    assert sorted(got) == sorted(want) == ["conv1", "conv2"]
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][leaf],
                                          np.asarray(want[name][leaf]))
    real = _clip(9)
    np.testing.assert_allclose(
        pe.svfid(real, [_clip(10)], weights_path=path,
                 feature_layer="conv2", device="cpu")["mean"],
        je.svfid(real, [_clip(10)], weights_path=path,
                 feature_layer="conv2")["mean"], rtol=STATS_RTOL)


def test_load_c3d_torch_checks(tmp_path, monkeypatch):
    path = str(tmp_path / "c3d.pth")
    torch.save(_state_dict("conv1"), path)
    with pytest.raises(KeyError, match="conv2.weight"):
        pc.load_c3d_torch(path, "conv2")
    bad = _state_dict("conv1")
    bad["conv1.weight"] = bad["conv1.weight"][:, :2]
    torch.save(bad, path)
    with pytest.raises(ValueError, match="not a Sports-1M C3D"):
        pc.load_c3d_torch(path, "conv1")
    torch.save(_state_dict("conv1"), path)
    monkeypatch.setenv("C3D_WEIGHTS_SHA256", "0" * 64)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        pc.load_c3d_torch(path, "conv1")
    monkeypatch.setenv("C3D_WEIGHTS_SHA256", pc._file_sha256(path).upper())
    assert "conv1" in pc.load_c3d_torch(path, "conv1")["params"]


def test_load_c3d_torch_full_module_fallback(tmp_path, caplog):
    """A pickled full module (the legacy mirrors) fails the safe load and
    is read with a warning."""
    model = pc.C3D("conv1")
    path = str(tmp_path / "c3d.pickle")
    torch.save(model, path)
    caplog.set_level(logging.WARNING)
    params = pc.load_c3d_torch(path, "conv1")["params"]
    assert any("weights_only=False" in r.getMessage()
               for r in caplog.records)
    np.testing.assert_array_equal(
        params["conv1"]["kernel"],
        model.conv1.weight.detach().numpy().transpose(2, 3, 4, 1, 0))


@pytest.mark.parametrize("shape,layer", [((1, 16, 16, 3), "conv3a"),
                                         ((4, 1, 16, 3), "conv2"),
                                         ((8, 16, 7, 3), "conv4a")])
def test_too_small_clip_raises(shape, layer):
    with pytest.raises(ValueError, match="too small for C3D tap"):
        ps.c3d_feature_stats(pc.random_c3d_params(layer), np.zeros(shape),
                             layer, device="cpu")
    assert ps._tap_min_shape(layer) == js._tap_min_shape(layer)


def test_tap_min_shapes_equal_jax():
    for name, _ in jc.C3D_LAYERS:
        assert ps._tap_min_shape(name) == js._tap_min_shape(name)
    with pytest.raises(ValueError):
        ps._tap_min_shape("fc7")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pe.svfid(_clip(0), [_clip(1)], feature_layer="conv1")
