"""Device time of one IG2G edit in the traced window: the stream time between the ``ig2g.edit`` span's events (the noisy render, the VAE encodes, the 20 UNet calls, the decode, the resize), idle inside it included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("ig2g.edit")
    if t.kind != "ig2g" or t.trace.busy_s <= 0 or not s \
            or s["calls"] <= 0:
        return None
    return 1e3 * s["device_s"] / s["calls"]
