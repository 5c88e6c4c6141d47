"""`portbench.run` on the CPU for the tests: every rank of a cell runs
here with gloo, and ``PORTBENCH_TEST_FAULT`` names a fault planted in the
program before the run (`faults.plant`)."""

import os
import sys

from portbench import run
from portbench.tests import faults

if __name__ == "__main__":
    faults.plant(os.environ.get("PORTBENCH_TEST_FAULT", ""))
    sys.exit(run.main(sys.argv[1:], device_type="cpu", rank_module="portbench.tests._cpu_rank"))
