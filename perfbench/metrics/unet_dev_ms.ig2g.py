"""Device time of one UNet call (a guidance batch of 3) in the traced window: the stream time between the ``ig2g.unet`` span's events (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("ig2g.unet")
    if t.kind != "ig2g" or t.trace.busy_s <= 0 or not s \
            or s["calls"] <= 0:
        return None
    return 1e3 * s["device_s"] / s["calls"]
