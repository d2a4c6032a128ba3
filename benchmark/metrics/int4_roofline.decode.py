"""The int4 kernel's share of its roofline: for every forward of the
traced window's calls (the prefill at batch x prompt rows, then each
single-token step at batch rows) the least time of its int4 products
(the packed weights, the scales, the activations in and the results out,
each byte once, at the HBM rate; or the FLOPs at the bf16 peak, whichever
is longer), over the device time of `int4_matmul_kernel`, in %."""

from benchmark import roofline


def read(run):
    pk = roofline.peak(run.device_name)
    if run.trace is None or pk is None or run.cell["runner"] != "decode":
        return None
    seconds = run.trace.op_seconds(lambda n: "int4_matmul_kernel" in n)
    if seconds <= 0:
        return None
    batch, new = run.mix["batch"], run.mix["new_tokens"]
    least = 0.0
    for p in run.unit_sizes:
        forwards = [batch * p] + [batch] * (new - 1)
        for rows in forwards:
            least += roofline.least_seconds(
                *roofline.int4_forward(run.shape, rows), pk)[0]
    return 100.0 * least / seconds
