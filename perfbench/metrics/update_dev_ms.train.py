"""Device time of the update (Adam on every field and the densification statistics) per training iteration: the stream time between the ``step.update`` span's events, idle inside it included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("step.update")
    if t.kind != "train" or not s or t.units <= 0:
        return None
    return 1e3 * s["device_s"] / t.units
