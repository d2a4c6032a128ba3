"""The whole training step's share of the card's bf16 peak: the
configuration's FLOPs a token (PaLM's accounting, top-k experts only)
times the traced window's tokens, over its time, in %."""

from benchmark import roofline


def read(run):
    pk = roofline.peak(run.device_name)
    if run.trace is None or pk is None or run.window_s <= 0:
        return None
    flops = roofline.train_flops_per_token(run.shape, run.mix["seq"]) \
        * run.work
    return 100.0 * flops / run.window_s / pk.bf16_flops
