"""The benchmark's own tests run on the CPU at tiny frame sizes (the
`cuda`-marked one on a card): `python -m pytest benchmark/tests -q`."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
