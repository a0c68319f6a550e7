"""Operation and byte counts from the shapes the benchmark sends: one file
for each kernel and one for the whole infer. Each input byte is counted read
once and each output byte written once. ``bound_s`` is the least time the
card could take: the larger of the operations over their peak and the bytes
over the memory bandwidth (``peaks.json``)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

PEAKS_FILE = Path(__file__).resolve().parents[1] / "peaks.json"


def peaks() -> Dict:
    return json.loads(PEAKS_FILE.read_text())
