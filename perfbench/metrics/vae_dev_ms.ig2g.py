"""Device time of the VAE in one IG2G edit in the traced window: the ``ig2g.vae_encode`` spans (the render, the original, the noise render) and the ``ig2g.vae_decode`` span, over the ``ig2g.edit`` spans (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    spans = trace.summary()["spans"]
    edit = spans.get("ig2g.edit")
    parts = [spans.get(k) for k in ("ig2g.vae_encode", "ig2g.vae_decode")]
    if t.kind != "ig2g" or t.trace.busy_s <= 0 or not edit \
            or edit["calls"] <= 0 or not all(parts):
        return None
    return 1e3 * sum(p["device_s"] for p in parts) / edit["calls"]
