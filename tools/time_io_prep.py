#!/usr/bin/env python3
"""Wall seconds of one checkout's "io" and "io prep" phases of
``chip_smoke.py``, on the card, for comparing two checkouts on one machine.

    python3 tools/time_io_prep.py [--checkout DIR] [--label NAME]

Imports DIR's ``chip_smoke.py`` and package (DIR: the checkout that holds
this script by default), runs its "io" phase (which builds the native
library, checks the fixtures and writes the card's originals) and then its
"io prep" phase, each printing ``phase io (NAME): S s of wall time`` as
``chip_smoke.py`` prints its phases, under the card's name and power limit.
The readers' own times are ``chip_smoke.io_main()``'s "time codecs"
phases.  To compare two checkouts, run both inside one call, in the order
A, B, B, A.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    label = f" ({args.label})" if args.label else ""
    print(f"checkout {root}{label}; card {card}")
    with tempfile.TemporaryDirectory() as tmp:
        with chip_smoke.phase(f"io{label}"):
            state = chip_smoke.io_checks(tmp)
        with chip_smoke.phase(f"io prep{label}"):
            chip_smoke.io_prep(state, tmp, root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
