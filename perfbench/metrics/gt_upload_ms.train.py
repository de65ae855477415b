"""Host wall time of the loop's ground-truth uploads per training iteration: the ``loop.gt_upload`` span's host interval, the copy's wait for the stream included (ms)."""


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("loop.gt_upload")
    if t.kind != "train" or not s or t.units <= 0:
        return None
    return 1e3 * s["host_s"] / t.units
