"""Closed loop: ``clients`` requests in flight, each resubmitted as soon as
its result is polled; a request's latency runs from its submission to its
result. The window ends with the first step that ends ``seconds`` after it
began; no request is resubmitted after that, and those in flight are
served to the end.
"""
from bench.harness import serving
from bench.harness.core import clock

MIX_KEYS = serving.MIX_KEYS | {"clients"}


def loop(client, cell, seed: int, seconds: float):
    t0 = clock()
    for _ in range(cell.traffic["clients"]):
        client.send(t0)
    end = None
    while client.live:
        if end is not None and clock() - end > serving.DRAIN_LIMIT_S:
            break
        finished = client.step(clock() - t0)
        if end is None and clock() - t0 >= seconds:
            end = finished[0].done if finished else clock()
        if end is None:
            for _ in finished:
                client.send(clock())
    return t0, (end if end is not None else clock())


def run(cell, seed, seconds, trace, device, t_start, ref, on_check=None):
    return serving.run(cell, seed, seconds, trace, device, t_start, ref, loop, on_check)
