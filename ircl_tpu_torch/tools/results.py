"""``RESULTS_TORCH.md``: the port's record of its measured experiments.

The experiment tools (``eval_e2e``, ``similarity_ab``, ``verdict_table2``)
each write one section between a pair of markers, under the marker names of
the reference's ``RESULTS.md``. A rerun replaces the one section between its
own pair and nothing else; a section whose markers are missing is appended.
The header, the text before the first marker, names the device of the last
run; every section names its own.
"""

from __future__ import annotations

import os
import re
import subprocess

import torch

TITLE = "# RESULTS_TORCH — the PyTorch port's measured experiments"


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else "nvidia-smi gave no answer"


def device_line(device) -> str:
    """``cpu``, or the card's name from torch and nvidia-smi's name and
    power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {nvidia_smi_line()})"


def write_section(path: str, begin: str, end: str, lines, device) -> str:
    """Writes ``lines`` between ``begin`` and ``end`` into ``path``, with the
    device named in the header and at the top of the section. Returns the
    section."""
    dev = device_line(device)
    section = "\n".join([begin, "", f"Device: {dev}", "", *lines, "", end])
    text = open(path).read() if os.path.exists(path) else ""
    first = text.find("<!-- ")
    body = text[first:] if first >= 0 else ""
    head = f"{TITLE}\n\nDevice of the last run: {dev}\n\n"
    pattern = re.escape(begin) + r".*?" + re.escape(end)
    if re.search(pattern, body, flags=re.S):
        body = re.sub(pattern, lambda _: section, body, count=1, flags=re.S)
    else:
        body = (body.rstrip() + "\n\n" if body.strip() else "") + section + "\n"
    with open(path, "w") as f:
        f.write(head + body)
    return section
