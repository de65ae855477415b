"""Device time of an IG2G edit's render in the traced window: the ``ig2g.edit_render`` span (the per-surfel noise draw, preprocess, binning, K1 with its noise channels, the bridge and the noise channels' min-max), over its calls (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("ig2g.edit_render")
    if t.kind != "ig2g" or t.trace.busy_s <= 0 or not s \
            or s["calls"] <= 0:
        return None
    return 1e3 * s["device_s"] / s["calls"]
