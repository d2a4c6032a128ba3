"""torch.cuda.max_memory_allocated() over the window, in GiB: the
program's state and work space, the benchmark holding nothing of its
own on the device."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2 ** 30
