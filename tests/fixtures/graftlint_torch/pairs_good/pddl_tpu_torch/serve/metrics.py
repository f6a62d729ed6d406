"""The metrics class the exposition's counter keys pair with."""


class ServeMetrics:
    def __init__(self):
        self.requests_finished = 0

    def snapshot(self):
        return {"requests_finished": self.requests_finished}
