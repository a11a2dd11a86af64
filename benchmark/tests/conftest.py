"""The harness's tests: ``python -m pytest benchmark/tests`` from the root
of the checkout (on the CPU; the ``gpu`` tests skip without a card)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
