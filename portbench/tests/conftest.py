"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from the
repository's root. The tests marked ``cuda`` run on a card and skip
without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
