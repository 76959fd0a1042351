"""The GPU a run used, as nvidia-smi reports it.  Every speed number is
kept beside the card's name and power limit: a card set below its
maximum power runs slower under load."""
from __future__ import annotations

import re
import subprocess
from typing import List


def cards() -> List[str]:
    """`name, power.limit` of each card; empty where nvidia-smi is
    missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def tag() -> str:
    """File-name tag of the first card, e.g. ``h100-80gb-hbm3_700w``."""
    found = cards()
    if not found:
        return "no-gpu"
    name, _, limit = found[0].rpartition(",")
    watts = re.sub(r"\.0+\s*W$", "w", limit.strip()).replace(" ", "").lower()
    name = re.sub(r"^nvidia\s+", "", name.strip(), flags=re.I)
    return re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-") + "_" + watts
