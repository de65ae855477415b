"""Places per view where the host waited for the device inside the render: the program's ``sync`` counter over the traced window's views (syncs)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()
    if t.kind != "render" or "render" not in s["spans"] or t.units <= 0:
        return None
    return s["counts"].get("sync", 0) / t.units
