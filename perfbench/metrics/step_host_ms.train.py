"""Host wall time of the training step per iteration: the ``loop.step`` span's host interval, launches and host syncs included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("loop.step")
    if t.kind != "train" or not s or t.units <= 0:
        return None
    return 1e3 * s["host_s"] / t.units
