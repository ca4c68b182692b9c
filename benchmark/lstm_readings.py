"""`readings.py` with the recurrent learner's faults (`tests/lstm_faults.py`)
beside the others:

    python3 benchmark/lstm_readings.py --workload lstm_selfplay_cramped --seeds 1,2 \
        --variant sound,tf32,lstm_zeroed_carry,lstm_half_batch
"""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(BENCH_DIR, "tests"))
import faults  # noqa: E402
import lstm_faults  # noqa: E402
import readings  # noqa: E402

if __name__ == "__main__":
    faults.PLANT.update(lstm_faults.PLANT)
    readings.main()
