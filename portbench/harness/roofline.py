"""A kernel's share of its roofline over a traced window: the bound time
of the work of every launch the window ran (each priced from its shape by
``yardstick``), over those launches' device time by kernel name."""
from __future__ import annotations

from typing import Optional

from .common import note
from .yardstick import dw_bound, k1_bound, pair_bound

__all__ = ["k1_share", "k2_share"]

K1_KERNELS = ("conv3d64_fwd_", "conv3d64_dw_")
K2_KERNELS = ("conv3d64_pair_",)


def _share(run, seconds_of, kernel: str, prefixes, label: str
           ) -> Optional[float]:
    if run.trace is None or run.launches is None:
        return None
    launches = run.launches.launches(kernel, "trace", run.units)
    spent = run.trace.kernel_time(*prefixes)
    if not launches or spent <= 0:
        return None
    by = {"operations": 0.0, "bytes": 0.0}
    for launch in launches:
        t, which = seconds_of(*launch)
        by[which] += t
    bound = sum(by.values())
    note(f"{label}: {len(launches)} launches, bound {bound:.6f} s "
         f"(operations {by['operations']:.6f}, bytes {by['bytes']:.6f}), "
         f"device time {spent:.6f} s, {run.trace.kernel_count(*prefixes)} "
         f"kernels")
    return 100.0 * bound / spent


def _k1(kind, shape, bias, bf16):
    if kind == "dw":
        return dw_bound(shape, bf16=bf16)
    return k1_bound(shape, bias=bias, bf16=bf16)


def _k2(kind, shape, bias, bf16):
    return pair_bound(shape, with_mid=kind == "mid", bf16=bf16)


def k1_share(run) -> Optional[float]:
    return _share(run, _k1, "k1", K1_KERNELS, "K1")


def k2_share(run) -> Optional[float]:
    return _share(run, _k2, "k2", K2_KERNELS, "K2")
