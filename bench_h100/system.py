"""The front end's view of a system under test: ``Entry``, the base of the
entries (``entries/<name>.py``). The system itself is the file of its
configuration's protocol, ``systems/<protocol>.py``.
"""

from __future__ import annotations

from collections import deque


class Entry:
    """A front end's view of the server: dispatch a batch, take the oldest
    batch's answers (a list of the system's results, one a query), drain
    what is left at the end."""

    def __init__(self):
        self.ready = deque()

    def take(self) -> list:
        return self.ready.popleft()()

    def drain(self) -> list[list]:
        out = [f() for f in self.ready]
        self.ready.clear()
        return out
