"""Device time of the render's prepare stage (activation, the SH mask, preprocess) per view: the stream time between the ``render.prepare`` span's events, idle inside it included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("render.prepare")
    if t.kind != "render" or not s or t.units <= 0:
        return None
    return 1e3 * s["device_s"] / t.units
