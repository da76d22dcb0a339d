"""Approximate-time message synchronization.

The reference ROS node joins depth image + RGB + point cloud with a
message_filters ApproximateTime synchronizer, queue size 50
(ros/Node.hpp:104-108,136-146). This is the transport-agnostic
equivalent: push timestamped messages per channel; when a set of
messages (one per channel) falls within `slop` seconds of each other,
the registered callback fires with the matched set. Used to feed
DetectionStream.process from unsynchronized sensor feeds.

A copy of `partsbaseddetector_tpu/apps/sync.py` (pure Python).
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class ApproximateTimeSynchronizer:
    def __init__(
        self,
        channels: Sequence[str],
        callback: Callable[..., None],
        queue_size: int = 50,
        slop: float = 0.05,
    ):
        self.channels = list(channels)
        self.callback = callback
        self.queue_size = int(queue_size)
        self.slop = float(slop)
        self._queues: Dict[str, List[Tuple[float, Any]]] = {
            c: [] for c in self.channels
        }

    def push(self, channel: str, stamp: float, msg: Any) -> bool:
        """Add a message; fires the callback (returns True) when a
        cross-channel match within slop exists. Matched and older
        messages are consumed."""
        q = self._queues[channel]
        # (stamp, seq, msg): seq breaks comparison ties without touching msg
        bisect.insort(q, (float(stamp), len(q), msg))
        if len(q) > self.queue_size:
            q.pop(0)
        return self._try_match()

    def _try_match(self) -> bool:
        if any(not q for q in self._queues.values()):
            return False
        # pivot: the latest head timestamp across channels; find in each
        # channel the message closest to the pivot
        best: Dict[str, Tuple[float, int, Any]] = {}
        pivot = max(q[0][0] for q in self._queues.values())
        for c, q in self._queues.items():
            cand = min(q, key=lambda t: abs(t[0] - pivot))
            if abs(cand[0] - pivot) > self.slop:
                # drop messages older than pivot - slop: they can never
                # match a future pivot either
                self._queues[c] = [t for t in q if t[0] >= pivot - self.slop]
                return False
            best[c] = cand
        # consume matched + older messages
        for c, q in self._queues.items():
            cut = best[c][0]
            self._queues[c] = [t for t in q if t[0] > cut]
        self.callback(*[best[c][2] for c in self.channels])
        return True
