"""Host wall time of one render per view: the ``render`` span's host interval, launches and host syncs included, without the wait for the device after it (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("render")
    if t.kind != "render" or not s or t.units <= 0:
        return None
    return 1e3 * s["host_s"] / t.units
