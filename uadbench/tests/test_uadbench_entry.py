"""The command's own behaviour on a machine without a card: it exits non-zero
and prints no result."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "uadbench/run.py", "--workload", "cddpm96.eval",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
