"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, and none of its sources imports them."""
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "hpvaegan_tpu_torch"

_PROBE = r"""
import sys
import hpvaegan_tpu_torch
import hpvaegan_tpu_torch.serving
import hpvaegan_tpu_torch.ops.kernels.conv3d_pack
import hpvaegan_tpu_torch.ops.kernels.conv3d_fuse
import hpvaegan_tpu_torch.losses
import hpvaegan_tpu_torch.train.trainer
import hpvaegan_tpu_torch.utils.convert
banned = {"jax", "flax", "optax", "cv2", "msgpack", "imageio", "tensorboardX"}
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in banned
                or m == "hpvaegan_tpu" or m.startswith("hpvaegan_tpu."))
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_import_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax_and_no_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|cv2|msgpack|"
        r"hpvaegan_tpu(\.|\s|$))", re.M)
    sources = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 10
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_kernel_sources_ship_with_the_package():
    """The CUDA sources live in the package (pyproject ships ``csrc``)."""
    for name in ("conv3d_pack", "conv3d_dw", "conv3d_fuse"):
        assert (PORT / "csrc" / f"{name}.cu").is_file()
    text = (REPO / "pyproject.toml").read_text()
    assert "csrc/*.cu" in text
