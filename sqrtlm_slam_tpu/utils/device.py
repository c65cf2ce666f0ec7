"""The card a run measured on, as `nvidia-smi` names it."""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """Name and power limit of each GPU ("name, limit; ..."), read without
    touching JAX. A card may be capped below its maximum power and then runs
    slower under load, so every reported time carries this string."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())
