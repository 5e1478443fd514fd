"""The harness's own tests: ``python -m pytest portbench/tests`` from the
repository's root. Those marked ``cuda`` run on a card and skip without
one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
