"""Training tokens a second: every token of every step in the window
over the window's whole time (host clock, ends in a synchronize)."""


def read(run):
    if run.cell["runner"] != "train" or run.window_s <= 0:
        return None
    return run.work / run.window_s
