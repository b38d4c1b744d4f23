"""A local experiment logger: JSON lines, resumable by key.

Port of ``piv_liteflownet_tpu/utils/metrics.py``. It keeps the call surface
of the comet-ml experiment the reference trainer used (``log_metric``,
``log_current_epoch``, ``log_parameters``, ``set_name``, ``get_key``) and
writes ``<workdir>/<key>/metrics.jsonl`` and ``parameters.json``.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional


class Experiment:
    """Local JSON-lines experiment logger; ``previous_experiment`` appends to an existing key."""

    def __init__(self, workdir: str = "./work/experiments", project_name: str = "piv-flownet",
                 previous_experiment: Optional[str] = None):
        self.project = project_name
        self.key = previous_experiment or uuid.uuid4().hex[:16]
        self.dir = os.path.join(workdir, self.key)
        os.makedirs(self.dir, exist_ok=True)
        mode = "a" if previous_experiment else "w"
        self._f = open(os.path.join(self.dir, "metrics.jsonl"), mode, buffering=1)
        self.name = None

    def set_name(self, name: str) -> None:
        self.name = name

    def get_key(self) -> str:
        return self.key

    def log_parameters(self, params: Dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "parameters.json"), "w") as f:
            json.dump({k: str(v) for k, v in params.items()}, f, indent=2)

    def log_current_epoch(self, epoch: int) -> None:
        self._write({"event": "epoch", "epoch": int(epoch)})

    def log_metric(self, name: str, value, step: Optional[int] = None,
                   epoch: Optional[int] = None) -> None:
        rec = {"metric": name, "value": float(value)}
        if step is not None:
            rec["step"] = int(step)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        self._write(rec)

    def _write(self, rec: Dict[str, Any]) -> None:
        rec["t"] = time.time()
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
