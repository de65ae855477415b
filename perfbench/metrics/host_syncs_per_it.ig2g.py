"""Places per iteration of the traced IG2G window where the host waited for the device: the program's ``sync`` counter over the window's iterations, the edit's included; none without the device (syncs)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()
    if t.kind != "ig2g" or t.trace.busy_s <= 0 or "loop.step" not in \
            s["spans"] or t.units <= 0:
        return None
    return s["counts"].get("sync", 0) / t.units
