"""The closed loop that the traffic clients build on: one caller that
sends its next request when the last has returned, for a fixed time."""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import List, Optional


@dataclasses.dataclass
class Timed:
    """What the measured window gives the metric readers."""

    latencies_s: List[float]
    images: int
    window_s: float
    failed: int
    per_request: Optional[int]  # images of every request, where all have as many


class ClosedLoop:
    """Subclasses give request() (returns the images it completed;
    raises RuntimeError where the program fails) and request_images
    (images a request covers, counted for a failed one)."""

    request_images = 1
    per_request: Optional[int] = None

    def request(self) -> int:
        raise NotImplementedError

    def window(self, seconds: float, clock=time.perf_counter) -> Timed:
        """Requests back to back until `seconds` have passed (at least
        one); the window ends with the request running then."""
        lat: List[float] = []
        images = failed = 0
        start = now = clock()
        while not lat or now - start < seconds:
            t0 = clock()
            try:
                done = self.request()
            except RuntimeError:
                if not failed:
                    traceback.print_exc(file=sys.stderr)
                failed += 1
                done = self.request_images
            now = clock()
            lat.append(now - t0)
            images += done
        return Timed(lat, images, now - start, failed, self.per_request)
