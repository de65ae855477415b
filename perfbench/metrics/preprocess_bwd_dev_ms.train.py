"""Device time of the preprocess's backward per training iteration: the stream time between the ``render.prepare_bwd`` span's events (the backward kernel of the render's preprocess Function, under ``step.backward``), idle inside it included (ms). A program without that span reads nothing."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("render.prepare_bwd")
    if t.kind != "train" or not s or t.units <= 0:
        return None
    return 1e3 * s["device_s"] / t.units
