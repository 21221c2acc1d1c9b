"""Sample metrics of the port (``hpvaegan_tpu/eval/__init__.py``).

Only the numpy metrics are here; SVFID and SIFID wait for ROADMAP Queue 1
item 10."""
from .metrics import diversity_score, psnr, reconstruction_psnr

__all__ = ["diversity_score", "psnr", "reconstruction_psnr"]
