"""Training metrics: per-epoch history CSV (reference-compatible) plus a
structured JSONL stream with throughput.

The port's own copy of the JAX package's framework-free
`training/metrics.py`: the same files in the same format, so either
package's trainer replays the other's logs. Only the primary-process test
differs: it asks `torch.distributed`, not JAX.

The reference dumps the Keras history dict to CSV per session
(trainer.py:58-60) with columns `loss`, `hg{i}_conv_1x1_predict_loss`,
`val_loss`, `val_hg{i}_conv_1x1_predict_loss`, and replays all session CSVs
at resume to report the last/best epochs (trainer.py:97-114). This module
reproduces that file format and adds what the reference lacked
(SURVEY.md §5): a JSONL metrics stream carrying step time and images/sec.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import time
from typing import Dict, List, Optional


def stack_metric_columns(train_metrics: Dict[str, float],
                         val_metrics: Dict[str, float],
                         num_stacks: int) -> Dict[str, float]:
    """Map internal metric names to the reference's Keras history columns."""
    row = {"loss": train_metrics["loss"]}
    for i in range(num_stacks):
        row[f"hg{i}_conv_1x1_predict_loss"] = train_metrics[f"loss/hg{i}"]
    row["val_loss"] = val_metrics["loss"]
    for i in range(num_stacks):
        row[f"val_hg{i}_conv_1x1_predict_loss"] = val_metrics[f"loss/hg{i}"]
    return row


class HistoryLogger:
    """Accumulates per-epoch rows; writes the session CSV at the end.

    Multi-process: only rank 0 writes the shared-filesystem CSV/JSONL
    (every process logs the same aggregated metrics, so concurrent writers
    would only duplicate and interleave rows); other ranks still
    accumulate rows in memory for their own session bookkeeping."""

    def __init__(self, logs_path: str, primary: Optional[bool] = None):
        if primary is None:
            import torch.distributed as dist

            primary = not (dist.is_available() and dist.is_initialized()) \
                or dist.get_rank() == 0
        self._primary = primary
        self.logs_path = logs_path
        self.rows: List[Dict[str, float]] = []
        os.makedirs(logs_path, exist_ok=True)
        self._jsonl = open(os.path.join(logs_path, "metrics.jsonl"), "a") \
            if primary else None

    def log_epoch(self, epoch: int, row: Dict[str, float],
                  step_time_s: Optional[float] = None,
                  images_per_sec: Optional[float] = None) -> None:
        self.rows.append(dict(row))
        record = {"epoch": epoch, **row, "time": time.time()}
        if step_time_s is not None:
            record["step_time_s"] = step_time_s
        if images_per_sec is not None:
            record["images_per_sec"] = images_per_sec
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def write_session_csv(self, epochs: int, learning_rate: float) -> str:
        """`log_E{epochs}_lr{lr}.csv` with a leading index column, matching
        the reference's pandas to_csv output (trainer.py:60)."""
        path = os.path.join(self.logs_path,
                            f"log_E{epochs}_lr{learning_rate}.csv")
        if not self.rows or not self._primary:
            return path
        cols = list(self.rows[0].keys())
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + cols)
            for i, row in enumerate(self.rows):
                w.writerow([i] + [row.get(c, "") for c in cols])
        return path

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


def read_all_session_logs(logs_path: str) -> List[Dict[str, float]]:
    """Replay every session CSV in order -> one row per epoch across all
    sessions (the reference's pd.concat over sorted globbed logs,
    trainer.py:98-99)."""
    rows: List[Dict[str, float]] = []
    for path in sorted(glob.glob(os.path.join(logs_path, "log_*.csv"))):
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            for r in reader:
                rows.append({k: float(v) for k, v in r.items()
                             if k not in ("", None) and v != ""})
    return rows


def best_val_loss(rows: List[Dict[str, float]]):
    """(best_val_loss, 1-based epoch) across replayed history; (None, None)
    if empty."""
    best = None
    best_epoch = None
    for i, r in enumerate(rows):
        v = r.get("val_loss")
        if v is not None and (best is None or v < best):
            best, best_epoch = v, i + 1
    return best, best_epoch
