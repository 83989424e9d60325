"""Entry ``app_wide``: the ``app`` entry (``entries/app.py``) for a wideband
device, whose block outgrows the ring a program may give its input.

A block of 20 Msps in s8 is 5,000,000 B.  A program whose device ring holds
less than one block (3,200,000 B, ten 320 kB buffers, before the rings were
sized to the block) never handles a block: its service loop waits for a
whole block in the ring, and the ``app`` entry would wait out its deadline.
Here ``App._service_once`` checks, while the entry runs, that a block has
reached the pipeline within ``STALL_S`` seconds of ``App.start``; if none
has, it raises and names the ring's and the block's sizes, so such a program
fails soon and cleanly.  Everything else is the ``app`` entry's.
"""

from __future__ import annotations

import time

from benchmark.harness import HERE, load_module

STALL_S = 30.0


def run(ctx) -> None:
    from rtlsdr_airband_tpu_torch.app import App

    start, service = App.start, App._service_once
    started: dict[int, float] = {}

    def timed_start(self, *a, **k):
        started[id(self)] = time.perf_counter()
        return start(self, *a, **k)

    def checked(self):
        worked = service(self)
        t0 = started.get(id(self))
        if t0 is not None and time.perf_counter() - t0 > STALL_S:
            if not any(rt.pipeline.blocks_processed for rt in self.devices):
                rt = self.devices[0]
                raise RuntimeError(f"no block reached the pipeline {STALL_S:.0f} s after the App started: the device's ring "
                                   f"holds {rt.input.ring.size} B, a block is {rt.bytes_per_block} B")
            started.pop(id(self))
        return worked

    App.start, App._service_once = timed_start, checked
    try:
        load_module(HERE / "entries" / "app.py", "benchmark_entry_app").run(ctx)
    finally:
        App.start, App._service_once = start, service
