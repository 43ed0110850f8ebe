"""What the run executes on: JAX's default device and, on NVIDIA GPUs, the
card's name and power limit (a card set below its maximum runs slower
under load, so every time printed next to it carries the limit)."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """`name, power.limit` of each card as nvidia-smi reports them, read by
    a child process that does not import JAX; 'not available' without
    nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({e.__class__.__name__})"
    if out.returncode != 0:
        return f"not available (nvidia-smi exit {out.returncode})"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def jax_device() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
