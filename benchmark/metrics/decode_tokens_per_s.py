"""Generated tokens a second: batch x new tokens of every `generate`
call in the window over the window's whole time, prefill, graph capture
and every decode step counted (host clock, ends in a synchronize)."""


def read(run):
    if run.cell["runner"] != "decode" or run.window_s <= 0:
        return None
    return run.work / run.window_s
