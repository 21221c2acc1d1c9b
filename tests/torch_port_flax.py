"""The port's modules as the JAX package's flax variable trees: the inverse
of ``hpvaegan_tpu_torch/utils/convert.py``, for the parity tests.

A test initialises a port model (seeded, in milliseconds) and hands the
JAX package these trees, instead of initialising the flax model and
growing it, which costs seconds of XLA compiles a model on the CPU.  The
trees follow the flax layouts the converter reads (``(*k, I, O)``
kernels, ``ConvND_0`` inside a ``ConvBlock``, BatchNorm
``scale/bias/mean/var``, spectral ``u`` and ``v`` in flax's ``(*k, I)``
flattening); ``tests/test_torch_port_baselines.py`` checks that the
converter reads them back into equal modules."""
import numpy as np


def _a(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _kernel(weight, thwio: bool) -> np.ndarray:
    """torch ``(O, I, *k)`` (or THWIO already) -> flax ``(*k, I, O)``."""
    w = _a(weight)
    if thwio:
        return w
    nd = w.ndim - 2
    return np.transpose(w, (*range(2, 2 + nd), 1, 0))


def conv(m) -> dict:
    """A ``ConvND``'s params."""
    return {"conv": {"kernel": _kernel(m.weight, m.kernel_route),
                     "bias": _a(m.bias)}}


def conv_block(m):
    """A ``ConvBlock``'s (params, batch_stats)."""
    params = {"ConvND_0": conv(m.conv)}
    if m.norm is None:
        return params, {}
    params["norm"] = {"scale": _a(m.norm.weight), "bias": _a(m.norm.bias)}
    return params, {"norm": {"mean": _a(m.norm.running_mean),
                             "var": _a(m.norm.running_var)}}


def snconv(m):
    """An ``SNConv``'s (params, spectral)."""
    kernel = _kernel(m.weight, False)
    v = _a(m.v).reshape(kernel.shape[-2], *kernel.shape[:-2])   # (I, *k)
    return ({"kernel": kernel, "bias": _a(m.bias)},
            {"u": _a(m.u), "v": np.moveaxis(v, 0, -1).reshape(-1)})


def encoder(m) -> dict:
    params, spectral = {"features": {}}, {"features": {}}
    for i, block in enumerate(m.features.conv_blocks):
        p, s = snconv(block)
        params["features"][f"conv_block_{i}"] = p
        spectral["features"][f"conv_block_{i}"] = s
    for name in ("bern", "mu", "logvar"):
        if hasattr(m, name):
            params[name] = conv(getattr(m, name))
    return {"params": params, "spectral": spectral}


def _blocks(named) -> dict:
    params, stats = {}, {}
    for name, block in named:
        params[name], bs = conv_block(block)
        if bs:
            stats[name] = bs
    return {"params": params, "batch_stats": stats}


def conv_stack(m) -> dict:
    """``Decoder``, ``Stage`` or ``SGStage``."""
    out = _blocks([("head", m.head)]
                  + [(f"block{i}", b) for i, b in enumerate(m.blocks)])
    out["params"]["tail"] = conv(m.tail)
    return out


def csg_stage(m) -> dict:
    return _blocks([(f"block{i}", b) for i, b in enumerate(m.blocks)])


def generator(G) -> dict:
    """Any port generator's ``gvars``."""
    if hasattr(G, "encode"):
        return {"encode": encoder(G.encode), "decoder": conv_stack(G.decoder),
                "body": [conv_stack(s) for s in G.body]}
    if G.has_head_tail:
        head = _blocks([("head", G.head)])
        return {"head": {"params": head["params"]["head"],
                         "batch_stats": head["batch_stats"]["head"]},
                "tail": {"params": conv(G.tail)},
                "body": [csg_stage(s) for s in G.body]}
    return {"body": [conv_stack(s) for s in G.body]}


def critic(D) -> dict:
    """The SN ``WDiscriminator``'s or the ``WDiscriminatorBaselines``'
    ``dvars``."""
    if D.sn_convs():
        params, spectral = {}, {}
        for name, m in [("head", D.head)] + [(f"block{i}", b)
                                             for i, b in enumerate(D.body)]:
            params[name], spectral[name] = snconv(m)
        params["tail"] = conv(D.tail)
        return {"params": params, "spectral": spectral}
    out = _blocks([("head", D.head)]
                  + [(f"block{i}", b) for i, b in enumerate(D.body)])
    out["params"]["tail"] = conv(D.tail)
    return out
