"""``python -m repro_torch.launch.train`` on the CPU: the 1m preset trains
a few steps with checkpoints, the run "crashes" (its last checkpoint is
deleted) and ``--resume`` repeats the uninterrupted run's final loss bit
for bit from the step and data cursor in the checkpoint's metadata."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.launch.train import PRESETS, build_parser, main

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _final(lines: str) -> str:
    last = lines.strip().splitlines()[-1]
    assert last.startswith("done. final loss: ")
    return last.split(": ", 1)[1]


def test_cli_resumes_bit_for_bit(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--preset", "1m", "--steps", "12", "--batch", "4", "--seq",
            "32", "--ckpt-dir", d, "--ckpt-every", "6", "--log-every", "3"]
    full = main(argv)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "model=lm-1m params=1.2M qat=True"
    logged = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(logged) == 4 and logged[-1] < logged[0]
    assert sorted(os.listdir(d)) == ["step_000000000006", "step_000000000012"]
    with open(os.path.join(d, "step_000000000006", "meta.json")) as f:
        assert json.load(f) == {"data_cursor": 6, "step": 6, "compressed": False}

    shutil.rmtree(os.path.join(d, "step_000000000012"))
    resumed = main(argv + ["--resume"])
    out2 = capsys.readouterr().out
    assert "resumed from step 6 (cursor=6)" in out2
    assert resumed == full and _final(out2) == _final(out)


def test_cli_resumed_at_its_last_step_takes_no_step(tmp_path, capsys):
    """Resuming a run whose newest checkpoint is its last step trains
    nothing and reports a nan loss (the reference's CLI raises there, its
    last metrics unbound)."""
    d = str(tmp_path / "ckpt")
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
            "--ckpt-dir", d, "--ckpt-every", "2"]
    main(argv)
    capsys.readouterr()
    assert main(argv + ["--resume"]) != main(argv + ["--resume"])      # nan
    out = capsys.readouterr().out
    assert "resumed from step 2 (cursor=2)" in out and out.strip().endswith("nan")


def test_cli_flags_are_the_references_plus_device():
    """The reference CLI's flags, plus the device and the multi-device run's
    (pods, their sync, the tensor-parallel "model" axis, the rendezvous and
    the backend), whose defaults are one pod with compression and error
    feedback on one model rank."""
    import repro.launch.train as ref

    assert ref.PRESETS == PRESETS
    dests = {a.dest for a in build_parser()._actions} - {"help"}
    assert dests == {"preset", "arch", "steps", "batch", "seq", "lr", "no_qat", "microbatches",
                     "ckpt_dir", "ckpt_every", "resume", "log_every", "device",
                     "pods", "pod_compression", "error_feedback", "model", "init_method",
                     "backend"}
    args = build_parser().parse_args([])
    assert args.device == "cuda"
    assert (args.pods, args.pod_compression, args.error_feedback) == (1, True, True)
    assert args.model == 1


@pytest.mark.parametrize("extra", [["--arch", "qwen3-moe-30b-a3b", "--microbatches", "2"],
                                   ["--no-qat"]])
def test_cli_arch_and_options(extra, capsys):
    loss = main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
                 "--log-every", "1"] + extra)
    assert torch.isfinite(torch.tensor(loss))
    assert "qat=False" in capsys.readouterr().out or "--no-qat" not in extra


def test_cli_module_runs_and_refuses_a_missing_card():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--steps", "2", "--log-every", "1", "--batch", "2", "--seq", "8"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert _final(res.stdout)
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--steps", "1"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
