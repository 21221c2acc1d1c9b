"""The port's parallel layer (``hpvaegan_tpu_torch/parallel/``) in one
process: the mesh shapes and the block rule against the JAX package's
``parallel/mesh.py``, ``make_mesh`` refusing a world of the wrong size,
``maybe_initialize``'s contract (the counterparts of
tests/test_distributed.py:85-118, and the raise when ``--distributed``
has no launcher), the backend rule, the ``multihost`` helpers in one
process (tests/test_multihost.py:153-197), K4's gate, and a non-primary
saver writing nothing.  The collectives themselves run on gloo ranks in
test_torch_port_conv3d_spmd.py, test_torch_port_spmd_steps.py and
test_torch_port_spmd_cli.py."""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hpvaegan_tpu.parallel import mesh as jmesh
from hpvaegan_tpu_torch.core.config import Config
from hpvaegan_tpu_torch.ops.kernels.conv3d_spmd import pconv_spmd_ok
from hpvaegan_tpu_torch.parallel import (block_rows, default_mesh_shape,
                                         make_mesh, maybe_initialize,
                                         multihost, parse_mesh_shape)
from hpvaegan_tpu_torch.parallel import distributed as pdist
from hpvaegan_tpu_torch.parallel.mesh import Mesh, check_replicated
from hpvaegan_tpu_torch.utils.saver import VideoSaver

W64 = (3, 3, 3, 64, 64)


@pytest.mark.parametrize("spec", ["2x4", "8", "1X2", "2x1", "1x1"])
def test_parse_mesh_shape_matches_jax(spec):
    assert parse_mesh_shape(spec) == jmesh.parse_mesh_shape(spec)


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_shape_matches_jax(n):
    assert default_mesh_shape(n) == jmesh.default_mesh_shape(n)


@pytest.mark.parametrize("n,parts", [(16, 2), (15, 2), (9, 2), (7, 4),
                                     (144, 4), (18, 4), (4, 4), (5, 3)])
def test_blocks_are_ordered_contiguous_and_longest_first(n, parts):
    blocks = block_rows(n, parts)
    assert blocks[0][0] == 0 and blocks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    sizes = [stop - start for start, stop in blocks]
    assert sizes == sorted(sizes, reverse=True)
    assert set(sizes) <= {-(-n // parts), n // parts} and min(sizes) >= 1


def test_a_block_may_not_be_empty():
    with pytest.raises(ValueError, match="at least one row"):
        block_rows(3, 4)


def test_make_mesh_needs_one_process_a_position():
    with pytest.raises(ValueError, match=r"needs 2 processes, have 1"):
        make_mesh((1, 2))
    mesh = make_mesh((1,))
    assert mesh.shape == (1, 1) and mesh.spatial_group is None


def test_a_one_rank_mesh_shards_and_sums_nothing():
    mesh = make_mesh((1, 1))
    x = torch.randn(2, 3, 5, 4, 8)
    assert torch.equal(mesh.shard(x, 2), x)
    assert mesh.gather_h(x, 2) is x and mesh.slice_h(x, 2) is x
    assert mesh.all_sum(x) is x and mesh.count(x) == x.numel()
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    mesh.sum_grads([p])
    assert torch.equal(p.grad, torch.full((3,), 2.0))


def test_a_rank_shards_its_batch_rows_and_h_block():
    """Rank (1, 2) of a (2, 3) mesh holds batch row 1 and rows 6-8 of an
    H of 9 (the mesh object alone: no process group needed)."""
    mesh = Mesh((2, 3), 5, 1, 2, (3, 4, 5))
    x = torch.arange(2 * 9).reshape(2, 1, 9, 1, 1).float()
    assert torch.equal(mesh.shard(x, 2), x[1:2, :, 6:9])
    assert mesh.neighbours() == (4, None)
    with pytest.raises(ValueError, match="batch of 3"):
        mesh.batch_rows(3)


def test_maybe_initialize_propagates_real_failures(monkeypatch):
    """A half-joined launch must fail, not train N single-process runs."""
    def boom(*a, **kw):
        raise RuntimeError("connection to coordinator failed")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="coordinator failed"):
        maybe_initialize(True, "127.0.0.1:1", 2, 0)


def test_maybe_initialize_keeps_a_group_already_up(monkeypatch):
    def twice(*a, **kw):
        raise AssertionError("initialized twice")

    monkeypatch.setattr(dist, "init_process_group", twice)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert maybe_initialize(True) == (1, 2)


def test_maybe_initialize_noop_when_disabled():
    assert maybe_initialize(False) == (0, 1)


def test_distributed_without_a_launcher_raises_naming_it(monkeypatch):
    for var in pdist.LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="HPVAEGAN_COORDINATOR, "
                       "HPVAEGAN_NUM_PROCESSES, HPVAEGAN_PROCESS_ID"):
        maybe_initialize(True)


def test_the_launcher_environment_names_the_launch(monkeypatch):
    monkeypatch.setenv("HPVAEGAN_COORDINATOR", "host0:1234")
    monkeypatch.setenv("HPVAEGAN_NUM_PROCESSES", "4")
    monkeypatch.setenv("HPVAEGAN_PROCESS_ID", "3")
    assert pdist.launcher_env() == ("host0:1234", 4, 3)
    monkeypatch.delenv("HPVAEGAN_PROCESS_ID")
    with pytest.raises(RuntimeError, match="HPVAEGAN_PROCESS_ID"):
        pdist.launcher_env()


@pytest.mark.parametrize("device,world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 8, "nccl"), ("cuda", 4, 2, "gloo")])
def test_nccl_only_when_every_rank_has_its_own_card(device, world, cards,
                                                   want):
    assert pdist.choose_backend(device, world, cards) == want


def test_multihost_helpers_in_one_process():
    assert multihost.is_primary()
    assert multihost.agree(7) == 7
    tree = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    assert multihost.broadcast_pytree(tree) is tree
    multihost.barrier("noop")   # a no-op in one process
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(multihost.fetch(x), x.numpy())
    np.testing.assert_array_equal(multihost.fetch(x.numpy()), x.numpy())
    check_replicated(torch.nn.Linear(2, 2))   # a no-op in one process


@pytest.mark.parametrize("shape,mesh_shape,ok", [
    ((2, 4, 144, 256, 64), (1, 2), True),
    ((2, 4, 15, 8, 64), (2, 2), True),     # uneven H: K4 takes it
    ((3, 4, 16, 8, 64), (2, 1), False),    # B % data
    ((2, 4, 3, 8, 64), (1, 4), False),     # an empty H block
    ((2, 4, 16, 8, 32), (1, 2), False),    # not 64 channels
    ((2, 16, 8, 64), (1, 2), False)])      # not 3D
def test_k4_gate(shape, mesh_shape, ok):
    mesh = Mesh(mesh_shape, 0, 0, 0, tuple(range(mesh_shape[1])))
    assert pconv_spmd_ok(shape, W64, mesh) is ok


def test_nonprimary_saver_writes_nothing(tmp_path, monkeypatch):
    """A saver on a rank other than 0 keeps the paths but never touches
    the file system."""
    monkeypatch.setattr(multihost, "is_primary", lambda: False)
    cfg = Config(video_path="clip.avi", run_dir=str(tmp_path))
    saver = VideoSaver(cfg)
    assert saver.experiment_dir.endswith("experiment_0")
    saver.save_checkpoint({"a": torch.ones(2)}, "netG", blocking=True)
    saver.save_json({"a": 1}, "config.json")
    saver.wait()
    assert os.listdir(tmp_path) == []
