"""The accelerator a measurement runs on.

Every number the benchmarks and the chip smoke test print carries the
device JAX reports and the card's name and power limit as `nvidia-smi`
reads them: a card set below its maximum power runs slower under load.
A measurement that finds no GPU stops; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Dict, List, Tuple

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def parse_nvidia_smi(text: str) -> List[Tuple[str, str]]:
    """(name, power limit) per card from `SMI_QUERY` output, e.g.
    'NVIDIA H100 80GB HBM3, 700.00 W'."""
    cards = []
    for line in text.splitlines():
        if not line.strip():
            continue
        name, sep, limit = line.rpartition(",")
        if not sep:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    return cards


def card_line() -> str:
    """The first card's `name, power.limit` line, read by `nvidia-smi`
    in a child process that does not touch JAX."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    cards = parse_nvidia_smi(out)
    if not cards:
        raise RuntimeError("nvidia-smi listed no card")
    return ", ".join(cards[0])


def require_gpu() -> Dict[str, object]:
    """{'platform', 'kind', 'count'} of JAX's devices; raises unless
    they are GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devices[0].platform!r}; this "
            "measurement does not fall back to another device")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}
