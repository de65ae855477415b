"""Device self time of the backward per training iteration: the ``step.backward`` span's stream time less its child ``raster.composite_bwd`` (K2 and the reduction), i.e. autograd through the bridge, the records' packing, preprocess and SH, idle included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("step.backward")
    if t.kind != "train" or not s or t.units <= 0:
        return None
    return 1e3 * s["device_self_s"] / t.units
