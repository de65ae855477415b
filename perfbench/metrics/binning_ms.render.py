"""Host wall time of one call of the binning (api.bin_preprocessed) in rendering, host syncs included (ms)."""

from perfbench.readers import span_ms


def read(t):
    return span_ms(t, "render", "bin_preprocessed")
