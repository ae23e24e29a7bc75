"""The device a tool or worker runs on, and its description."""

from __future__ import annotations

import subprocess

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where ``cuda`` is asked for
    and there is no card (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, and no card")
    return dev


def describe(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (``torch``'s name of
    the card where ``nvidia-smi`` does not answer), or ``cpu``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(index)


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
