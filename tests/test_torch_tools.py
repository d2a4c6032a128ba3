"""The port's compute tools (kubeflow_tpu_torch/tools/) on the CPU.

Each tool's --cpu run (TINY-sized) prints its JSON lines with the keys
the card's runs carry, names the CPU as its device and no nvidia-smi
line; without --cpu and without a card each tool exits non-zero instead
of falling back.  The sweep (`mfu_sweep.drive`), given a fake runner in
place of subprocess.run, starts one `--run` process per config, carries
on past a failed config, appends every record to the results file it is
given and measures a stage's top configs again; a failed config's
record keeps its exception's line, not the traceback.  The numbers of a
CPU run measure no card; only their shape is checked.  Their byte
counts are held to the reference's ci/ scripts in
tests/test_torch_decode.py."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from kubeflow_tpu_torch.tools import (
    decode_ablate,
    decode_profile,
    kv_cache_probe,
    llama7b_decode,
    longctx_sweep,
    mfu_sweep,
)

COMMON = {"tool", "measurement", "device", "nvidia_smi"}

# tool -> (its main, --cpu argv, {measurement: keys beyond COMMON})
CASES = {
    "decode_profile": (decode_profile.main, ["--cpu", "--probe-bw"], {
        "hbm_read": {"gbps", "bytes", "windows"},
        "variant": {"variant", "weights", "cuda_graph", "batch",
                    "prompt_len", "new_tokens", "tok_s", "step_ms",
                    "traffic_mb", "effective_gbps"},
        "roofline": {"weight_mb", "kv_mb", "batch", "roofline_basis",
                     "roofline_tok_s"}}),
    "kv_cache_probe": (kv_cache_probe.main, ["--cpu"], {
        **{body: {"shape", "iters", "ms_per_iter", "cache_mb",
                  "cache_equiv_gbps", "moved_mb", "moved_gbps",
                  "moved_share_of_hbm", "hbm_gbps"}
           for body in ("update-only", "read-only", "read+update")},
        "ideal": {"shape", "ms_per_iter", "hbm_gbps"}}),
    "decode_ablate": (decode_ablate.main, ["--cpu"], {
        "baseline": {"config", "batch", "prompt_len", "new_tokens",
                     "windows", "tok_s", "step_ms", "weight_mb", "kv_mb",
                     "ideal_ms", "gap_ms", "hbm_gbps", "effective_gbps"},
        **{name: {"config", "batch", "prompt_len", "new_tokens", "windows",
                  "tok_s", "step_ms", "weight_mb", "kv_mb", "ideal_ms",
                  "gap_ms", "hbm_gbps", "effective_gbps", "delta_ms",
                  "removed_mb", "removed_ms"}
           for name in ("kv-heads/2", "vocab/2", "layers/2", "batch x2")}}),
    "llama7b_decode": (llama7b_decode.main, ["--cpu"], {
        "decode": {"metric", "value", "unit", "vs_baseline", "detail"}}),
}


@pytest.mark.parametrize("tool", sorted(CASES))
def test_cpu_run_prints_its_schema(tool, capsys):
    main, argv, schema = CASES[tool]
    main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["measurement"] for x in lines] == [
        m for m in schema for _ in range(
            2 if tool == "decode_profile" and m == "variant" else 1)]
    for line in lines:
        assert set(line) == COMMON | schema[line["measurement"]], line
        assert line["tool"] == tool
        assert line["device"] == "cpu" and line["nvidia_smi"] is None


def test_sweep_run_prints_one_line(capsys):
    mfu_sweep.main(["--run", json.dumps({"batch": 2, "seq": 32,
                                         "remat_policy": "dots"}), "--cpu"])
    (line,) = capsys.readouterr().out.splitlines()
    result = json.loads(line)
    assert set(result) == {"mfu", "tokens_per_s", "step_time_s", "loss",
                           "setup_s", "peak_memory_gb",
                           "flash_launches_per_step", "batch", "seq",
                           "num_steps", "device", "nvidia_smi"}
    assert result["device"] == "cpu" and result["mfu"] is None
    assert (result["batch"], result["seq"], result["num_steps"]) == (2, 32, 2)
    assert result["flash_launches_per_step"] == {
        "flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}
    assert result["loss"] > 0


@pytest.mark.parametrize("tool", sorted(CASES) + ["mfu_sweep"])
def test_no_card_no_fallback(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = ((mfu_sweep.main, ["--run", "{}"]) if tool == "mfu_sweep"
                  else (CASES[tool][0], []))
    with pytest.raises(SystemExit) as exit_:
        main(argv)
    assert "no CUDA device" in str(exit_.value.code)


class FakeRunner:
    """subprocess.run's stand-in: one `--run` process a call; the specs
    in `fail` end as an out-of-memory would, the others print a line
    whose MFU is `mfu(spec)`."""

    def __init__(self, fail: list, mfu):
        self.calls, self.fail, self.mfu = [], fail, mfu

    def __call__(self, argv, capture_output, text, timeout, cwd):
        assert capture_output and text and timeout > 0
        assert cwd == mfu_sweep.ROOT
        self.calls.append(argv)
        spec = json.loads(argv[4])
        if spec in self.fail:
            return subprocess.CompletedProcess(
                argv, 1, "", "Traceback (most recent call last):\n"
                "  File \"train.py\", line 1, in step\n"
                "torch.OutOfMemoryError: CUDA out of memory\n")
        line = json.dumps({"mfu": self.mfu(spec), "tokens_per_s": 1.0,
                           "step_time_s": 1.0})
        return subprocess.CompletedProcess(argv, 0, f"warming up\n{line}\n",
                                           "")


@pytest.mark.parametrize("tool", [mfu_sweep, longctx_sweep])
def test_sweep_runs_one_process_per_config(tool, tmp_path):
    specs = [{**tool.BASE, **s} for _, stage, _ in tool.STAGES
             for s in stage]
    fail = [specs[1]]

    def mfu(spec):
        return 0.1 + spec["batch"] / 1000 + len(json.dumps(spec)) / 1e6

    runner = FakeRunner(fail, mfu)
    results = tmp_path / "sweep.jsonl"
    results.write_text('{"an": "earlier run"}\n')
    records = mfu_sweep.drive(tool.STAGES, tool.BASE, results, runner=runner,
                              cpu=True)

    confirmed = []
    for label, stage, confirm in tool.STAGES:
        ok = [{**tool.BASE, **s} for s in stage]
        ok = sorted((s for s in ok if s not in fail), key=mfu,
                    reverse=True)[:confirm]
        confirmed += ok
    assert len(runner.calls) == len(specs) + len(confirmed)
    for argv, spec in zip(runner.calls, specs + confirmed):
        assert argv[:4] == [sys.executable, "-m",
                            "kubeflow_tpu_torch.tools.mfu_sweep", "--run"]
        assert json.loads(argv[4]) == spec and argv[5:] == ["--cpu"]
    assert [r["spec"] for r in records if not r.get("confirm")] == specs
    assert [r["spec"] for r in records if r.get("confirm")] == confirmed
    failed = [r for r in records if "error" in r]
    assert [r["spec"] for r in failed] == fail
    assert failed[0]["rc"] == 1
    assert failed[0]["error"] == "torch.OutOfMemoryError: CUDA out of memory"
    lines = [json.loads(x) for x in results.read_text().splitlines()]
    assert lines == [{"an": "earlier run"}] + records
