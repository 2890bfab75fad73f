"""Publisher: an abstract extension point called at the end of each cycle (port of
m3t_tpu/publisher.py; reference m3t/include/m3t/publisher.h, no concrete publisher
ships in the library, M3T/readme.md:109-110)."""

from __future__ import annotations


class Publisher:
    def __init__(self, name: str, metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.set_up = False

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = True
        return True

    def UpdatePublisher(self, iteration: int) -> bool:  # noqa: N802
        return True
