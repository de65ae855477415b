"""Device time of the reduction of K2's per-slot gradient rows to per-surfel rows per training iteration: the stream time between the ``raster.reduce`` span's events, idle inside it included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("raster.reduce")
    if t.kind != "train" or not s or t.units <= 0:
        return None
    return 1e3 * s["device_s"] / t.units
