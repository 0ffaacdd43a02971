"""Segmented-run manifest: idempotent restart for sharded workloads (a
copy of grtcode_tpu/utils/segments.py).

The reference's de-facto checkpointing is the per-segment output file —
each SLURM rank writes `<out>.nc.<index>` and a crashed run is resumed by
rerunning missing segments by hand (GRTworkflow/run-era5.sh:137,
SURVEY.md §5).  This module keeps that stateless-segment property and
adds what the reference leaves to the operator: done-markers written
atomically after a segment's output is complete, and a resume planner
that lists exactly the segments still to run.

Any (column-shard x band) unit is idempotently recomputable, so a retry
of an unfinished segment is always safe.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time


@dataclasses.dataclass
class SegmentManifest:
    """Done-markers next to segment outputs: `<output>.done` holds a JSON
    record (segment id, output path, wall time); presence == completion.

    The marker is written via os.replace (atomic on POSIX), so a crash
    mid-write never yields a false "done".
    """

    directory: str

    def _marker(self, segment_id: str) -> str:
        return os.path.join(self.directory, f"{segment_id}.done")

    def mark_done(self, segment_id: str, output_path: str, **extra) -> None:
        os.makedirs(self.directory, exist_ok=True)
        record = {"segment": segment_id, "output": output_path,
                  "finished_at": time.time(), **extra}
        tmp = self._marker(segment_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self._marker(segment_id))

    def is_done(self, segment_id: str) -> bool:
        return os.path.exists(self._marker(segment_id))

    def record(self, segment_id: str) -> dict:
        with open(self._marker(segment_id)) as f:
            return json.load(f)

    def pending(self, segment_ids) -> list[str]:
        """Segments still to (re)run — the resume plan."""
        return [s for s in segment_ids if not self.is_done(s)]

    def clear(self, segment_id: str) -> None:
        """Invalidate a segment (forces recomputation)."""
        try:
            os.remove(self._marker(segment_id))
        except FileNotFoundError:
            pass


def run_segments(manifest: SegmentManifest, segments: dict, run_fn) -> list:
    """Run `{segment_id: args}` through `run_fn(segment_id, args) ->
    output_path`, skipping already-done segments and marking each as it
    completes.  Returns the ids run this invocation."""
    ran = []
    for sid in manifest.pending(list(segments)):
        out = run_fn(sid, segments[sid])
        manifest.mark_done(sid, str(out))
        ran.append(sid)
    return ran
