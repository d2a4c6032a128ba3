"""The whole decode loop's share of its roofline: for every `generate`
call of the traced window, the least time its prefill and each decode
step need at the published peaks (FLOPs at the bf16 peak or bytes at
the HBM rate, whichever is longer: the int4 weights and scales, the
cache up to each step's position, the activations), summed, over the
window's time, in %.  The steps are bound by bytes."""

from benchmark import roofline


def read(run):
    pk = roofline.peak(run.device_name)
    if run.trace is None or pk is None or run.cell["runner"] != "decode":
        return None
    mix = run.mix
    least = sum(roofline.generate_call(run.shape, mix["batch"], p,
                                       mix["new_tokens"], pk)
                for p in run.unit_sizes)
    return 100.0 * least / run.window_s
