"""Subscriber: an abstract extension point called at the beginning of each cycle (port
of m3t_tpu/subscriber.py; reference m3t/include/m3t/subscriber.h)."""

from __future__ import annotations


class Subscriber:
    def __init__(self, name: str, metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.set_up = False

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = True
        return True

    def UpdateSubscriber(self, iteration: int) -> bool:  # noqa: N802
        return True
