"""peak_gib.train: the device memory the allocator held over the measured
window (``max_memory_reserved`` after a reset at its start: the tensors,
the blocks it keeps cached and a CUDA graph's private pool, which a
replay uses without an allocation), in GiB."""


def read(run):
    if run.kind != "train" or not run.window_reserved_bytes:
        return None
    return run.window_reserved_bytes / 2 ** 30
