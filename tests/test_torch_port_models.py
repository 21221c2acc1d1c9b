"""The port's pure-Python core, ops and network modules against the JAX
package, on the same weights (carried over by ``utils/convert.py``) and the
same inputs.  f32 tolerance rtol=2e-3, atol=2e-4 (tests/test_torch_parity.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpvaegan_tpu.core import config as jconfig
from hpvaegan_tpu.core import pyramid as jpyramid
from hpvaegan_tpu.models import blocks as jblocks
from hpvaegan_tpu.models import networks as jnets
from hpvaegan_tpu.ops import resize as jresize
from hpvaegan_tpu_torch.core import config as tconfig
from hpvaegan_tpu_torch.core import pyramid as tpyramid
from hpvaegan_tpu_torch.models import blocks as tblocks
from hpvaegan_tpu_torch.models import networks as tnets
from hpvaegan_tpu_torch.models.generators import (to_model_layout,
                                                  to_public_layout)
from hpvaegan_tpu_torch.ops import noise as tnoise
from hpvaegan_tpu_torch.ops import resize as tresize
from hpvaegan_tpu_torch.ops.kernels import conv3d_pack as cp
from hpvaegan_tpu_torch.utils import convert

RTOL, ATOL = 2e-3, 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jit(fn):
    """The JAX side, jitted: one compile is far cheaper here than eager
    op-by-op dispatch."""
    return jax.jit(fn)


def _port(module, x, *args):
    with torch.no_grad():
        out = module(to_model_layout(x), *args)
    return to_public_layout(out).numpy()


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# core: verbatim copies
# ---------------------------------------------------------------------------

def test_pyramid_tables_match_and_golden_schedule():
    """The wingsuit clip's geometry (256x144, 24 fps) at the default
    pyramid: the shapes the full-width main path runs."""
    args = dict(img_size=256, ar=0.5625, min_size=32, max_size=256,
                scale_factor_init=0.75, sampling_rates=(4, 3, 2, 1),
                org_fps=24.0)
    ours = tpyramid.Pyramid.for_video(**args)
    theirs = jpyramid.Pyramid.for_video(**args)
    assert ours.all_shapes3d() == theirs.all_shapes3d()
    assert ours.all_shapes3d() == [
        (4, 18, 33), (4, 23, 41), (4, 28, 51), (5, 36, 65), (5, 45, 81),
        (5, 57, 102), (7, 72, 129), (7, 91, 162), (7, 114, 204),
        (13, 144, 256)]
    assert [ours.fps(i) for i in range(10)] == \
        [theirs.fps(i) for i in range(10)]
    scaled = tpyramid.ScaledPyramid(ours, 1.5, 2.0, 0.5)
    jscaled = jpyramid.ScaledPyramid(theirs, 1.5, 2.0, 0.5)
    assert [scaled.shape3d(i) for i in range(10)] == \
        [jscaled.shape3d(i) for i in range(10)]


@pytest.mark.parametrize("kind", ["image", "video", "video_baselines"])
def test_parser_flags_and_defaults_match(kind):
    def table(parser):
        return {a.dest: (a.default, a.option_strings) for a in parser._actions}
    assert table(tconfig.build_parser(kind)) == \
        table(jconfig.build_parser(kind))


def test_config_fields_and_adjust_scales_match():
    ours, theirs = tconfig.Config(pconv_all=True), jconfig.Config(
        pconv_all=True)
    ours.adjust_scales()
    theirs.adjust_scales()
    assert ours.snapshot_dict() == theirs.snapshot_dict()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]


# ---------------------------------------------------------------------------
# ops: noise and resize
# ---------------------------------------------------------------------------

def test_generate_noise_kinds():
    g = torch.Generator().manual_seed(0)
    ref = torch.zeros(2, 3, 4, 5, 6).contiguous(
        memory_format=torch.channels_last_3d)
    n = tnoise.generate_noise(ref=ref, generator=g)
    assert n.shape == ref.shape and n.dtype == torch.float32
    assert n.is_contiguous(memory_format=torch.channels_last_3d)
    assert abs(float(n.mean())) < 0.2 and abs(float(n.std()) - 1) < 0.2
    bern = tnoise.generate_noise(size=(1000,), type="benoulli", generator=g)
    assert set(bern.unique().tolist()) == {0.0, 1.0}
    uni = tnoise.generate_noise(size=(1000,), type="whatever", generator=g)
    assert float(uni.min()) >= 0 and float(uni.max()) < 1
    ints = tnoise.generate_noise(size=(100,), type="int", emb_size=5,
                                 generator=g)
    assert int(ints.min()) >= 0 and int(ints.max()) < 5
    with pytest.raises(ValueError):
        tnoise.generate_noise()


@pytest.mark.parametrize("size", [(7, 9, 11), (3, 4, 5), (4, 6, 8)])
def test_interpolate_3d_matches(size):
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 8, 3)).astype(
        np.float32)
    ref = jresize.interpolate_3d(jnp.asarray(x), size)
    got = to_public_layout(tresize.interpolate_3d(to_model_layout(x), size))
    _close(got.numpy(), ref)


def test_interpolate_2d_matches_4d_and_per_frame_5d():
    rng = np.random.default_rng(1)
    x4 = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    x5 = rng.standard_normal((2, 4, 6, 8, 3)).astype(np.float32)
    got4 = to_public_layout(tresize.interpolate_2d(to_model_layout(x4),
                                                   (9, 5)))
    got5 = to_public_layout(tresize.interpolate_2d(to_model_layout(x5),
                                                   (9, 5)))
    _close(got4.numpy(), jresize.interpolate_2d(jnp.asarray(x4), (9, 5)))
    _close(got5.numpy(), jresize.interpolate_2d(jnp.asarray(x5), (9, 5)))


# ---------------------------------------------------------------------------
# blocks and networks, weights carried over by utils/convert.py
# ---------------------------------------------------------------------------

def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("cin,cout,pconv", [(3, 8, False), (64, 64, True)])
def test_convblock_train_mode(cin, cout, pconv):
    """conv -> BN on batch statistics -> LeakyReLU; (64, 64, pconv) takes
    the K1 route."""
    x = _x((2, 4, 6, 5, cin))
    jblock = jblocks.ConvBlock(features=cout, ker_size=3, padding=1, ndim=3,
                               pconv=pconv)
    v = _np(_jit(lambda k, x: jblock.init(k, x, True))(
        jax.random.PRNGKey(0), x))
    ref, _ = _jit(lambda v, x: jblock.apply(v, x, True,
                                            mutable=["batch_stats"]))(v, x)

    block = tblocks.ConvBlock(cin, cout, 3, 1, ndim=3, pconv=pconv)
    assert block.conv.kernel_route == pconv
    convert.load_conv_block(block, v["params"], v["batch_stats"])
    before = block.norm.running_mean.clone()
    cp.counts.reset()
    _close(_port(block, x, True), ref)
    assert cp.counts.plain_calls == int(pconv)
    # sampling never writes the loaded running statistics
    assert torch.equal(block.norm.running_mean, before)


def test_convblock_eval_mode_uses_running_stats():
    x = _x((2, 3, 5, 4, 3), seed=1)
    rng = np.random.default_rng(2)
    jblock = jblocks.ConvBlock(features=8, ker_size=3, padding=1, ndim=3)
    v = _np(_jit(lambda k, x: jblock.init(k, x, True))(
        jax.random.PRNGKey(1), x))
    v["batch_stats"] = {"norm": {
        "mean": rng.standard_normal(8).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}}
    ref = _jit(lambda v, x: jblock.apply(v, x, False))(v, x)
    block = tblocks.ConvBlock(3, 8, 3, 1, ndim=3)
    convert.load_conv_block(block, v["params"], v["batch_stats"])
    _close(_port(block, x, False), ref)


@pytest.mark.parametrize("ndim", [2, 3])
def test_snconv_with_stored_uv(ndim):
    """sigma from the stored (advanced once) u/v, no power iteration in
    the forward; v re-ordered by the converter."""
    shape = (2, 4, 6, 5, 3) if ndim == 3 else (2, 6, 5, 3)
    x = _x(shape, seed=3)
    jconv = jblocks.SNConv(features=8, ker_size=3, padding=1, ndim=ndim)
    v = _np(_jit(jconv.init)(jax.random.PRNGKey(2), x))
    v["spectral"] = _np(_jit(jblocks.spectral_update)(v["params"],
                                                      v["spectral"]))
    ref = _jit(jconv.apply)(v, x)
    conv = tblocks.SNConv(3, 8, 3, 1, ndim=ndim)
    convert.load_snconv(conv, v["params"], v["spectral"])
    _close(_port(conv, x), ref)


def test_encoder_matches():
    x = _x((2, 4, 6, 5, 3), seed=4)
    jenc = jnets.EncodeVAE(latent_dim=8, nfc=16, ker_size=3, enc_blocks=2,
                           ndim=3)
    v = _np(_jit(jenc.init)(jax.random.PRNGKey(3), x))
    mu_ref, logvar_ref = _jit(jenc.apply)(v, x)
    enc = tnets.EncodeVAE(3, 8, 16, 3, enc_blocks=2, ndim=3)
    convert.load_encoder(enc, v)
    with torch.no_grad():
        mu, logvar = enc(to_model_layout(x))
    _close(to_public_layout(mu).numpy(), mu_ref)
    _close(to_public_layout(logvar).numpy(), logvar_ref)


def test_decoder_matches():
    z = _x((2, 4, 6, 5, 8), seed=5)
    jdec = jnets.Decoder(nfc=16, nc_im=3, ker_size=3, padd_size=1,
                         num_layer=2, ndim=3)
    v = _np(_jit(lambda k, z: jdec.init(k, z, True))(
        jax.random.PRNGKey(4), z))
    ref, _ = _jit(lambda v, z: jdec.apply(v, z, True,
                                          mutable=["batch_stats"]))(v, z)
    dec = tnets.Decoder(8, 16, 3, 3, 1, num_layer=2, ndim=3)
    convert.load_conv_stack(dec, v)
    _close(_port(dec, z, True), ref)


def test_stage_matches_with_kernel_route():
    """nfc 64 + pconv: both block convs go through K1 (its plain version
    on the CPU); head 3->64 and tail 64->3 stay on stock convs."""
    x = _x((2, 4, 6, 5, 3), seed=6)
    jstage = jnets.Stage(nfc=64, nc_im=3, ker_size=3, padd_size=1,
                         num_layer=2, ndim=3, pconv=True)
    v = _np(_jit(lambda k, x: jstage.init(k, x, True))(
        jax.random.PRNGKey(5), x))
    ref, _ = _jit(lambda v, x: jstage.apply(v, x, True,
                                            mutable=["batch_stats"]))(v, x)
    stage = tnets.Stage(64, 3, 3, 1, num_layer=2, ndim=3, pconv=True)
    assert [b.conv.kernel_route for b in stage.blocks] == [True, True]
    assert not stage.head.conv.kernel_route and not stage.tail.kernel_route
    convert.load_conv_stack(stage, v)
    cp.counts.reset()
    _close(_port(stage, x, True), ref)
    assert cp.counts.plain_calls == 2 and cp.counts.fwd_launches == 0


@pytest.mark.parametrize("training", [True, False])
def test_reparameterize_with_explicit_eps(training):
    rng = np.random.default_rng(7)
    mu, logvar, eps = (rng.standard_normal((2, 3, 4)).astype(np.float32)
                       for _ in range(3))
    got = tnets.reparameterize(torch.from_numpy(mu),
                               torch.from_numpy(logvar), training,
                               eps=torch.from_numpy(eps))
    ref = eps * np.exp(0.5 * logvar) + mu if training else eps
    _close(got.numpy(), ref)
