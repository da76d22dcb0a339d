"""detect_many(frames, microbatch=...): the whole pool a request, the
batch server or folder job. Parameters: those of every detector mix
(benchmark/lib/detection.py), and

    microbatch     detect_many's microbatch
    trace_frames   frames of the traced request (one microbatch group)
"""

from benchmark.lib import detection

KEYS = detection.KEYS | {"microbatch", "trace_frames"}


class Client(detection.Client):
    @property
    def request_images(self):
        return len(self.frames)

    @property
    def per_request(self):
        return len(self.frames)

    def call(self):
        return list(enumerate(self.det.detect_many(self.frames,
                                                   microbatch=self.p["microbatch"])))

    def warm_call(self):
        m = self.p["microbatch"]
        self.det.detect_many(self.frames[:m], microbatch=m)

    def traced_request(self):
        n, m = self.p["trace_frames"], self.p["microbatch"]
        return (lambda: self.det.detect_many(self.frames[:n], microbatch=m)), n
