"""bench.py --smoke as a test (VERDICT r1 item 2c).

Round 1 shipped a bench entry that crashed on a trace-time assert while
95 unit tests stayed green, because nothing executed bench.py's exact
call shapes. This runs the real bench script end-to-end (tiny genome,
CPU) and checks the JSON contract the driver parses.
"""

import json
import subprocess
import sys


def test_bench_smoke_cpu():
    proc = subprocess.run(
        [sys.executable, "bench.py", "--smoke", "--cpu", "--batch", "256"],
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = proc.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["unit"] == "reads/s"
    assert out["value"] > 0
    assert out["vs_baseline"] > 0
    ex = out["extras"]
    assert ex["k2_reads_per_s"] > 0
    # the rows-per-read roofline models the GPU (CPU gather cost is
    # width-dependent, so the calibrated rate doesn't model the CPU
    # pipeline); the smoke only checks it computes and is positive
    assert ex["sol_fraction"] > 0
    assert ex["k2_sol_fraction"] > 0
    assert ex["ns_per_row_measured"] > 0
    assert ex["platform"] == "cpu"
    # no device peak on the CPU: the bandwidth share is not measured
    assert ex["hbm_gbps_peak"] is None
    assert ex["hbm_frac_of_byte_bw"] is None
