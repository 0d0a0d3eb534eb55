"""Deterministic event record / replay (port of `3dworld_tpu/utils/events.py`,
host code copied whole).

The reference records srand + every resize/mouse/keyboard event per frame
into a user-event list and replays whole sessions (`-uel` flag,
u_event.cpp:23-60, event types u_event.h:9-12) — combined with seeded RNG
this reproduces runs exactly.

Here: a frame-stamped journal of (frame, kind, payload...) rows; record
during a live run, then `Replay` feeds the same events back at the same
frames, driving identical simulation inputs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

# event kinds (~ u_event.h)
EV_SRAND = 0
EV_KEY = 1
EV_MOUSE = 2
EV_CAMERA = 3
EV_SPAWN = 4
EV_BRUSH = 5


@dataclass
class EventJournal:
    events: list = field(default_factory=list)  # (frame, kind, payload)

    def record(self, frame: int, kind: int, *payload):
        self.events.append((frame, kind, list(payload)))

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.events, f)

    @classmethod
    def load(cls, path: str) -> "EventJournal":
        j = cls()
        j.events = [tuple(e[:2]) + (e[2],) for e in json.load(open(path))]
        return j


class Replay:
    """Feed recorded events back frame by frame."""

    def __init__(self, journal: EventJournal):
        self.events = sorted(journal.events, key=lambda e: e[0])
        self.pos = 0

    def events_for_frame(self, frame: int):
        out = []
        while self.pos < len(self.events) and self.events[self.pos][0] <= frame:
            if self.events[self.pos][0] == frame:
                out.append(self.events[self.pos])
            self.pos += 1
        return out

    @property
    def done(self) -> bool:
        return self.pos >= len(self.events)
