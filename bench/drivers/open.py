"""Open loop: one request per due time of the mix's arrival law
(``arrivals``, `bench/arrivals/<law>.py`), whatever the engine is doing.

A sender thread stamps each request's arrival at its due time into an
inbox, as a server's receive queue would hold it. The engine's thread
takes what has arrived before each step and runs steps while the engine
holds work. So a request's arrival minus its due time is the generator's
own lateness, and its admission into a slot minus its arrival is the wait
that the engine puts on it (the running step, then the queue). Latency
runs from the due time. Every request due in the window is waited for, up
to a minute past its close.
"""
import collections
import threading

from bench.harness import registry, serving
from bench.harness.core import clock

MIX_KEYS = serving.MIX_KEYS | {"arrivals"}
IDLE_WAIT_S = 0.05


class Sender(threading.Thread):
    """Puts (due, arrived) into ``inbox`` at each due time (absolute, on
    `clock`); ``ready`` is set after each arrival."""

    def __init__(self, due):
        super().__init__(name="bench-sender", daemon=True)
        self.due = due
        self.inbox = collections.deque()
        self.arrived = 0
        self.ready = threading.Event()
        self.halt = threading.Event()

    def run(self) -> None:
        for d in self.due:
            wait = float(d) - clock()
            if wait > 0 and self.halt.wait(wait):
                return
            self.inbox.append((float(d), clock()))
            self.arrived += 1
            self.ready.set()

    def take(self):
        out = []
        while self.inbox:
            out.append(self.inbox.popleft())
        return out


def loop(client, cell, seed: int, seconds: float):
    spec = cell.traffic["arrivals"]
    offsets = registry.arrivals(cell.root, spec).offsets(seed, spec, seconds)
    t0 = clock()
    sender = Sender(t0 + offsets)
    sender.start()
    try:
        while True:
            sender.ready.clear()
            for due, arrived in sender.take():
                client.send(due, arrived)
            if client.live:
                if clock() - t0 > seconds + serving.DRAIN_LIMIT_S:
                    break
                client.step(clock() - t0)
                client.backlog.append((clock() - t0, sender.arrived,
                                       client.engine.pending() + len(sender.inbox)))
            elif sender.is_alive():
                sender.ready.wait(IDLE_WAIT_S)
            elif not sender.inbox:
                break
    finally:
        sender.halt.set()
        sender.join()
    return t0, clock()


def run(cell, seed, seconds, trace, device, t_start, ref, on_check=None):
    return serving.run(cell, seed, seconds, trace, device, t_start, ref, loop, on_check)
