"""Operations and bytes of one call of the SD-1.5 UNet2DCondition
(InstructPix2Pix), from its published widths and the latent's shape
only, and the least time an H100 could take for it in float16.

Operations are 2 per multiply-add of every convolution, every linear
layer (the timestep MLP, the projections, GEGLU) and the two products of
attention (q·kᵀ and the weights times v), as
``torch.utils.flop_counter.FlopCounterMode`` counts them. Left out, as
that counter leaves them out: biases, GroupNorm and LayerNorm, SiLU,
GELU and the GEGLU gate, softmax and its scaling, the residual adds, the
skip concatenations, the nearest upsampling and the sinusoidal timestep
embedding; together they are well under 1% of the operations at the
cell's shapes. Bytes count each weight once and the call's input, text
states and output once, in the call's dtype; activations that a fused
kernel could keep on chip are not counted.

The latent's shape comes from the image's by the VAE's three stride-2
downsamplings, each after a (0, 1, 0, 1) pad: a side s becomes s // 2.
"""

from __future__ import annotations

PEAK_FP16_FLOPS = 989e12          # H100 SXM, dense FP16 tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3


def latent_side(side: int, downsamplings: int = 3) -> int:
    for _ in range(downsamplings):
        side = side // 2
    return side


class _Tally:
    def __init__(self, batch: int):
        self.b, self.flops, self.params = batch, 0, 0

    def conv(self, ci, co, k, hw):
        self.flops += 2 * self.b * co * ci * k * k * hw[0] * hw[1]
        self.params += co * ci * k * k + co

    def linear(self, rows, ci, co, bias=True):
        self.flops += 2 * rows * ci * co
        self.params += ci * co + (co if bias else 0)

    def norm(self, c):
        self.params += 2 * c

    def attention(self, t, s, c):
        self.flops += 4 * self.b * t * s * c

    def resnet(self, ci, co, hw, temb):
        self.norm(ci)
        self.conv(ci, co, 3, hw)
        self.linear(self.b, temb, co)
        self.norm(co)
        self.conv(co, co, 3, hw)
        if ci != co:
            self.conv(ci, co, 1, hw)

    def transformer(self, c, hw, ctx_len, ctx_dim):
        n = hw[0] * hw[1]
        rows = self.b * n
        self.norm(c)
        self.conv(c, c, 1, hw)
        for _ in range(3):
            self.norm(c)
        for _ in range(3):                          # attn1 q, k, v
            self.linear(rows, c, c, bias=False)
        self.attention(n, n, c)
        self.linear(rows, c, c)
        self.linear(rows, c, c, bias=False)         # attn2 q
        for _ in range(2):                          # attn2 k, v
            self.linear(self.b * ctx_len, ctx_dim, c, bias=False)
        self.attention(n, ctx_len, c)
        self.linear(rows, c, c)
        self.linear(rows, c, 8 * c)                 # GEGLU
        self.linear(rows, 4 * c, c)
        self.conv(c, c, 1, hw)


def unet_call(cfg: dict, batch: int, latent_hw, ctx_len: int = 77,
              dtype_bytes: int = 2) -> dict:
    """{"flops", "params", "bytes", "seconds"} of one call at ``batch`` ×
    ``latent_hw``; ``seconds`` is the larger of the operations at the
    FP16 peak and the bytes at the HBM peak."""
    ch = list(cfg["block_out_channels"])
    n, L = len(ch), int(cfg["layers_per_block"])
    ctx_dim = int(cfg["cross_attention_dim"])
    temb = 4 * ch[0]
    t = _Tally(batch)
    t.linear(batch, ch[0], temb)
    t.linear(batch, temb, temb)
    sizes = [tuple(int(s) for s in latent_hw)]
    for _ in range(n - 1):
        h, w = sizes[-1]
        sizes.append(((h - 1) // 2 + 1, (w - 1) // 2 + 1))
    t.conv(int(cfg["in_channels"]), ch[0], 3, sizes[0])
    skips = [ch[0]]
    c_in = ch[0]
    for i in range(n):
        for j in range(L):
            t.resnet(c_in, ch[i], sizes[i], temb)
            c_in = ch[i]
            if i < n - 1:
                t.transformer(ch[i], sizes[i], ctx_len, ctx_dim)
            skips.append(ch[i])
        if i < n - 1:
            t.conv(ch[i], ch[i], 3, sizes[i + 1])
            skips.append(ch[i])
    t.resnet(ch[-1], ch[-1], sizes[-1], temb)
    t.transformer(ch[-1], sizes[-1], ctx_len, ctx_dim)
    t.resnet(ch[-1], ch[-1], sizes[-1], temb)
    c = ch[-1]
    for i in range(n):
        level = n - 1 - i
        co = ch[level]
        for j in range(L + 1):
            t.resnet(c + skips.pop(), co, sizes[level], temb)
            c = co
            if i > 0:
                t.transformer(co, sizes[level], ctx_len, ctx_dim)
        if i < n - 1:
            t.conv(co, co, 3, sizes[level - 1])
    t.norm(ch[0])
    t.conv(ch[0], int(cfg["out_channels"]), 3, sizes[0])
    hw = sizes[0][0] * sizes[0][1]
    io = batch * (int(cfg["in_channels"]) + int(cfg["out_channels"])) * hw \
        + batch * ctx_len * ctx_dim
    nbytes = dtype_bytes * (t.params + io)
    return {"flops": float(t.flops), "params": t.params,
            "bytes": float(nbytes),
            "seconds": max(t.flops / PEAK_FP16_FLOPS, nbytes / PEAK_BYTES)}
