"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, nor any package the card's machine lacks (flax, msgpack, tqdm,
tensorboard, tensorboardX, moviepy, PIL, OpenCV), and none of its
sources, nor chip_smoke.py, imports them; only the frames tool imports
OpenCV, which no other module imports."""
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "hpvaegan_tpu_torch"
FRAMES_TOOL = PORT / "tools" / "decode_frames.py"

_PROBE = r"""
import sys
import torch  # may load tqdm itself where tqdm is installed
before = set(sys.modules)
import hpvaegan_tpu_torch
import hpvaegan_tpu_torch.serving
import hpvaegan_tpu_torch.ops.kernels.conv3d
import hpvaegan_tpu_torch.ops.kernels.conv3d_pack
import hpvaegan_tpu_torch.ops.kernels.conv3d_fuse
import hpvaegan_tpu_torch.ops.kernels.conv3d_spmd
import hpvaegan_tpu_torch.parallel
import hpvaegan_tpu_torch.parallel.distributed
import hpvaegan_tpu_torch.parallel.mesh
import hpvaegan_tpu_torch.parallel.multihost
import hpvaegan_tpu_torch.losses
import hpvaegan_tpu_torch.train.trainer
import hpvaegan_tpu_torch.train.trainer_baselines
import hpvaegan_tpu_torch.train.steps
import hpvaegan_tpu_torch.train.optim
import hpvaegan_tpu_torch.models.generators
import hpvaegan_tpu_torch.models.networks
import hpvaegan_tpu_torch.models.registry
import hpvaegan_tpu_torch.cli.train_video_baselines
import hpvaegan_tpu_torch.tools.repro_probe
import hpvaegan_tpu_torch.utils.convert
import hpvaegan_tpu_torch.utils.saver
import hpvaegan_tpu_torch.data.video
import hpvaegan_tpu_torch.data.loader
import hpvaegan_tpu_torch.cli.train_video
import hpvaegan_tpu_torch.cli.generate
import hpvaegan_tpu_torch.cli.serve
import hpvaegan_tpu_torch.eval
import hpvaegan_tpu_torch.eval.c3d
import hpvaegan_tpu_torch.eval.jax_init
import hpvaegan_tpu_torch.eval._svfid
import hpvaegan_tpu_torch.eval._sifid
import hpvaegan_tpu_torch.data.image
import hpvaegan_tpu_torch.cli.train_image
import hpvaegan_tpu_torch.utils.png
import hpvaegan_tpu_torch.utils.summaries
import hpvaegan_tpu_torch.utils.video_io
import hpvaegan_tpu_torch.tools.decode_frames
banned = {"jax", "flax", "optax", "cv2", "msgpack", "imageio", "tensorboard",
          "tensorboardX", "moviepy", "PIL", "tqdm"}
loaded = sorted(m for m in set(sys.modules) - before
                if m.split(".")[0] in banned
                or m == "hpvaegan_tpu" or m.startswith("hpvaegan_tpu."))
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_import_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _importing(names):
    return re.compile(r"^\s*(import|from)\s+(" + names + r")(\.|\s|$)", re.M)


def test_sources_import_no_jax_and_no_jax_package():
    pattern = _importing(r"jax|flax|optax|msgpack|tqdm|tensorboard"
                         r"|tensorboardX|moviepy|PIL|imageio|hpvaegan_tpu")
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_only_the_frames_tool_imports_opencv():
    pattern = _importing("cv2")
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    importers = [p for p in sources if pattern.search(p.read_text())]
    assert importers == [FRAMES_TOOL]


def test_kernel_sources_ship_with_the_package():
    """The CUDA sources live in the package (pyproject ships ``csrc``)."""
    for name in ("conv3d_pack", "conv3d_dw", "conv3d_fuse", "conv3d_lrelu"):
        assert (PORT / "csrc" / f"{name}.cu").is_file()
    text = (REPO / "pyproject.toml").read_text()
    assert "csrc/*.cu" in text
