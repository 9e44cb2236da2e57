"""The card a measurement runs on: JAX's view of it and nvidia-smi's.

Scripts that time the device (bench.py, chip_smoke.py, benchmarks/)
call ``require_gpu`` first: a measurement without a GPU fails instead of
falling back to the CPU.
"""

from __future__ import annotations

import subprocess


def card_info() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it
    (the power limit bounds the card's clocks under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu() -> dict:
    """{platform, kind, count} of the JAX devices; exits non-zero unless
    they are GPUs."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {platform!r} devices")
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}
