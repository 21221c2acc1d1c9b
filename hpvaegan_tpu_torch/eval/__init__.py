"""Sample metrics of the port (``hpvaegan_tpu/eval/__init__.py``): the
numpy metrics, and SVFID (C3D) and SIFID (the Inception stem) on the
card.  The implementations live in ``_svfid.py``/``_sifid.py``: the public
functions are named ``svfid``/``sifid``, and same-named submodules would
be shadowed by these re-exports."""
from .metrics import diversity_score, psnr, reconstruction_psnr
from ._svfid import frechet_distance, svfid
from ._sifid import sifid

__all__ = ["diversity_score", "psnr", "reconstruction_psnr",
           "frechet_distance", "svfid", "sifid"]
