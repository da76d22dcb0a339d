"""detect(frame): one frame a request, the pool's frames taken in turn,
the camera or ROS node that waits for each frame. Parameters: those of
every detector mix (benchmark/lib/detection.py)."""

from benchmark.lib import detection

KEYS = detection.KEYS


class Client(detection.Client):
    per_request = 1

    def call(self):
        i = self.next % len(self.frames)
        self.next += 1
        return [(i, self.det.detect(self.frames[i]))]

    def warm_call(self):
        self.det.detect(self.frames[0])

    def traced_request(self):
        return (lambda: self.det.detect(self.frames[0])), 1
