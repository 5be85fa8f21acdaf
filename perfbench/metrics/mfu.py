"""Model FLOP utilisation: the operations the window's requests need
(`perfbench.flops.request_flops`, counted from the configuration and the
traffic, never from what the implementation does) over the window's seconds
times the chip's bfloat16 peak, in percent."""


def read(r):
    if not r.peaks or r.window_s <= 0:
        return None
    return 100.0 * r.model_flops / (r.window_s * r.peaks["bf16_flops"])
