"""The UNet call's least time on the H100 (``counts/sd_unet.py``: the operations of the published widths at the latent's shape at 989 TFLOP/s FP16 dense, or its weights and inputs at 3.35 TB/s, whichever is longer) over its traced device time, the ``ig2g.unet`` span's mean; none without the device (%)."""

from perfbench.counts import sd_unet


def read(t):
    try:
        from gs2d_torch.utils import trace
    except ImportError:
        return None
    s = trace.summary()["spans"].get("ig2g.unet")
    if t.kind != "ig2g" or t.trace.busy_s <= 0 or not t.views or not s \
            or s["calls"] <= 0 or s["device_s"] <= 0:
        return None
    v = t.views[0]
    hw = [sd_unet.latent_side(x) for x in v["image"]]
    bound = sd_unet.unet_call(v["unet"], v["batch"], hw, v["ctx_len"],
                              v["dtype_bytes"])["seconds"]
    return 100.0 * bound * s["calls"] / s["device_s"]
