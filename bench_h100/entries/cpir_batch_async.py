"""cpir_batch_async: ``TorchPirServer.private_encrypted_query_batch_async``.
Each dispatch returns its own future."""

import system


class Entry(system.Entry):
    def __init__(self, server):
        super().__init__()
        self.server = server

    def dispatch(self, batch: list) -> None:
        self.ready.append(self.server.private_encrypted_query_batch_async(batch))


def make(server) -> Entry:
    return Entry(server)
