"""Places per training iteration where the host waited for the device: the program's ``sync`` counter over the traced window's iterations (syncs)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()
    if t.kind != "train" or "loop.step" not in s["spans"] or t.units <= 0:
        return None
    return s["counts"].get("sync", 0) / t.units
