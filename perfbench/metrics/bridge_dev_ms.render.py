"""Device time of the bridge (background, world normals, depths, the depth normals with their two matrix inverses, the noise's min and max) per view: the stream time between the ``render.bridge`` span's events, idle inside it included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("render.bridge")
    if t.kind != "render" or not s or t.units <= 0:
        return None
    return 1e3 * s["device_s"] / t.units
