"""The kernel-variant timing tool's experiments still apply to the
sources in ``csrc/`` (its runs on the card are what PERF.md cites)."""
import pytest

from hpvaegan_tpu_torch.ops.kernels import _build
from hpvaegan_tpu_torch.tools import kernel_variants as kv


@pytest.mark.parametrize("experiment", sorted(kv.EXPERIMENTS))
def test_every_variant_edits_its_source_once(experiment):
    name, sources = kv.variant_sources(experiment)
    base = (_build.CSRC_DIR / f"{name}.cu").read_text()
    edits = kv.EXPERIMENTS[experiment][1]
    assert set(sources) == set(edits)
    for variant, text in sources.items():
        # the source itself is one of the variants; every other differs
        assert (text == base) == (not edits[variant])
    assert sum(text == base for text in sources.values()) == 1


def test_a_stale_edit_raises(monkeypatch):
    monkeypatch.setitem(kv.EXPERIMENTS, "stale", (
        "conv3d_fuse", {"gone": [("no such text in the source", "x")]}))
    with pytest.raises(ValueError, match="exactly once"):
        kv.variant_sources("stale")
