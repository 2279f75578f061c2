"""Run the FULL 108-cell reference grid through the JAX engines, on record.

Sets AAD_TPU_FULL_GRID=1 and runs tests/test_corpus_jax_grid.py — the full
real-audio product the reference executes through its codec under test
(reference: test/test_aad_encode_decode.c:492-636) plus the uncapped
fused-decode cells — then prints the record
``{"passed", "failed", "seconds", "ok"}`` and, given a path, writes it
there as JSON.

Usage: python tools/run_full_grid.py [record_path]
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent


def run_pytest(args: list[str], env: dict) -> tuple[int, int, float, str]:
    """(passed, failed, seconds, tail) for one pytest invocation."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", *args, "-q"],
        cwd=_REPO, env=env, capture_output=True, text=True,
    )
    dt = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    passed = failed = 0
    for pat, setter in ((r"(\d+) passed", "p"), (r"(\d+) failed", "f"),
                        (r"(\d+) error", "f")):
        m = re.search(pat, out)
        if m:
            if setter == "p":
                passed = int(m.group(1))
            else:
                failed += int(m.group(1))
    if proc.returncode != 0 and failed == 0:
        failed = -1  # collection error etc.
    return passed, failed, dt, out[-2000:]


def main() -> int:
    env = dict(os.environ)
    env["AAD_TPU_FULL_GRID"] = "1"
    passed, failed, secs, tail = run_pytest(
        ["tests/test_corpus_jax_grid.py"], env
    )
    record = {
        "passed": passed,
        "failed": failed,
        "seconds": round(secs, 1),
        "ok": failed == 0 and passed > 0,
    }
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(record, indent=1) + "\n")
    print(tail.splitlines()[-1] if tail.strip() else "")
    print(json.dumps(record))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
