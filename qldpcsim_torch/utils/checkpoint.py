"""Per-p-point counter checkpoints for sweeps that can be killed (port of
`qldpcsim_tpu/utils/checkpoint.py`; one process, one writer).

Counters are integers and chunk keys derive from the global chunk index, so
a resume is idempotent: a rerun of a completed chunk would give the same
counts, and completed chunks are skipped.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional, Tuple


class CheckpointStore:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, run_id: str) -> str:
        return os.path.join(self.dir, f"{run_id}.json")

    def save(self, run_id: str, counters: Dict[str, int], chunks_done: int):
        payload = {"counters": counters, "chunks_done": chunks_done}
        # Atomic write: temp file + rename, so a kill mid-write never
        # corrupts the checkpoint.
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(run_id))

    def load(self, run_id: str) -> Optional[Tuple[Dict[str, int], int]]:
        path = self._path(run_id)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            payload = json.load(f)
        return payload["counters"], payload["chunks_done"]
