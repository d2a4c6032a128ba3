"""The benchmark of the PyTorch/CUDA port (`kubeflow_tpu_torch`).

One command runs one cell once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is data found by name: the cell
(`cells/<name>.json`), its configuration (`configs/<name>.json`), its
traffic mix (`traffic/<name>.json`) and each metric
(`metrics/<name>.py`).  `reference/` is the plain float32 model the runs
are checked against; it imports nothing of the port.  See README.md.
"""
