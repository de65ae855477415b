"""Device time of one training step between IG2G edits in the traced window: the stream time between the ``loop.step`` span's events (render, losses, backward, Adam), idle inside it included, over its calls (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("loop.step")
    if t.kind != "ig2g" or t.trace.busy_s <= 0 or not s \
            or s["calls"] <= 0:
        return None
    return 1e3 * s["device_s"] / s["calls"]
