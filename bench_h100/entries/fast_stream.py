"""fast_stream: ``TorchPirServer.fast_serving_stream()``. submit(k)
dispatches batch k and hands back batch k-1's future; flush() the last
one's."""

import system


class Entry(system.Entry):
    def __init__(self, server):
        super().__init__()
        self.stream = server.fast_serving_stream()

    def dispatch(self, batch: list) -> None:
        fut = self.stream.submit(batch)
        if fut is not None:
            self.ready.append(fut)

    def drain(self) -> list[list]:
        fut = self.stream.flush()
        if fut is not None:
            self.ready.append(fut)
        return super().drain()


def make(server) -> Entry:
    return Entry(server)
