"""``python -m repro_torch.launch.train`` (the port of ``repro.launch.
train``) on the CPU at the qwen2.5-3b smoke config: the declarative
phases and the legacy split, the reference's summary keys, its argument
errors, and that it asks for the card without ``--device``.
"""
import json
import os
import subprocess
import sys

import torch

# keys of the reference's summary (repro/launch/train.py)
SUMMARY_KEYS = {"arch", "backend", "schedule", "steps", "first_loss", "final_loss",
                "mean_step_s", "restarts", "calibrations", "final_calib_loss", "mode_steps",
                "compile_stats", "fleet_steps", "backward_steps", "gate_refreshes",
                "gate_events", "optim_compress"}


def _train_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_cli_on_cpu_and_asks_for_the_card(tmp_path):
    report = tmp_path / "r" / "report.json"
    out = _train_cli("--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--backend",
                     "approx_mult", "--site-backend", "mlp_*=log_mult", "--phase", "exact:1",
                     "--phase", "inject:2:calib=1", "--phase", "model:1", "--batch", "2",
                     "--seq-len", "8", "--ckpt-dir", str(tmp_path / "ck"), "--log-every", "1",
                     "--report", str(report))
    assert out.returncode == 0, out.stderr
    summary = json.loads(report.read_text())
    assert set(summary) == SUMMARY_KEYS
    assert summary["schedule"] == "exact:1 -> inject:2[every_n] -> model:1"
    assert summary["steps"] == 4 and summary["calibrations"] == 2
    assert summary["mode_steps"] == {"no_model": 1, "inject": 2, "model": 1}
    assert summary["compile_stats"] == {"built": 4}
    assert summary["restarts"] == 0 and summary["backward_steps"] == {"exact": 4}
    assert sum(l.startswith("[inject] step") for l in out.stdout.splitlines()) == 2
    legacy = _train_cli("--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--backend",
                        "analog", "--inject-steps", "2", "--finetune-steps", "1", "--batch", "2",
                        "--seq-len", "8", "--ckpt-dir", str(tmp_path / "ck2"))
    assert legacy.returncode == 0, legacy.stderr
    assert '"schedule": "inject:2[every_n] -> model:1"' in legacy.stdout
    bad = _train_cli("--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--phase",
                     "inject:2", "--steps", "3")
    assert bad.returncode == 2 and "--steps conflicts with --phase" in bad.stderr
    if not torch.cuda.is_available():
        out = _train_cli("--arch", "qwen2.5-3b", "--smoke", "--steps", "1",
                         "--ckpt-dir", str(tmp_path / "ck3"))
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
