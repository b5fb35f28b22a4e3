"""Split-file handling (a copy of ``ssde_tpu/data/splits.py`` :21-51).

KITTI split lists live under ``splits/<name>/{train,val,test}_files.txt``
with lines ``"<scene_dir> <frame_idx> <l|r>"``, beside the GRU pipeline's
scene lists (``train_sequences.txt``). They are read from ``splits_dir``,
else ``$SSDE_SPLITS_DIR``, else the repo's vendored ``splits/``.
``tests/test_torch_kitti.py`` holds the copy to the original.
"""

from __future__ import annotations

import os
from typing import List

DEFAULT_SPLITS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "splits")


def readlines(filename: str) -> List[str]:
    """Read all lines, stripped (reference utils.py:14-19)."""
    with open(filename) as f:
        return f.read().splitlines()


def split_file(split: str, which: str, splits_dir: str | None = None) -> str:
    """Path to ``splits/<split>/<which>_files.txt``, or to ``<which>.txt``
    when only that exists: frame lists are ``train_files.txt``, scene and
    odometry lists ``train_sequences.txt`` / ``test_files_09.txt``."""
    d = splits_dir or os.environ.get("SSDE_SPLITS_DIR") or DEFAULT_SPLITS_DIR
    cand = os.path.join(d, split, f"{which}_files.txt")
    alt = os.path.join(d, split, f"{which}.txt")
    if not os.path.exists(cand) and os.path.exists(alt):
        return alt
    return cand


def parse_line(line: str):
    """``"<folder> <frame_index> <side>"`` -> (folder, frame_index, side)."""
    parts = line.split()
    folder = parts[0]
    frame_index = int(parts[1]) if len(parts) == 3 else 0
    side = parts[2] if len(parts) == 3 else None
    return folder, frame_index, side
