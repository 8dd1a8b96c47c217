"""Recovery drills: hold a started engine's sources at chosen polls, and
cut a run right after a checkpoint sealed and before its commit.

A source polls its control queue after every batch it emits
(``TaskRunner.poll_source_control``).  :func:`hold_sources` wraps that
poll so that at each chosen poll count the source waits until a control
message is queued for it, which pins how many batches precede each
barrier whatever the timing.  :func:`cut_before_commit` drives
checkpoints and commits at those holds and ends the run with an
IMMEDIATE stop while the last epoch's pre-commits are staged: what a
crash between a sealed checkpoint and its commit leaves behind.  A
restore from that epoch (``restore_epoch``) must then finish the
commit.  The functions read only the engine's ``subtasks`` and the
``RunningEngine`` calls, which the JAX package's engine has too, so
tests drive both packages through them."""

from __future__ import annotations

import asyncio
from typing import Any, Callable, List, Sequence


def hold_sources(engine: Any, polls: Sequence[int]) -> List[asyncio.Event]:
    """Hold every source of a started ``engine`` at each poll count in
    ``polls`` until a control message is queued for it; one event a poll
    count, set when a source reaches it."""
    events = {n: asyncio.Event() for n in polls}
    for h in engine.subtasks.values():
        if not h.is_source:
            continue
        runner, count = h.runner, [0]

        async def held(_r=runner, _poll=runner.poll_source_control,
                       _n=count):
            _n[0] += 1
            ev = events.get(_n[0])
            if ev is not None:
                ev.set()
                while _r.control_rx.empty():
                    await asyncio.sleep(0.001)
            return await _poll()

        runner.poll_source_control = held
    return [events[n] for n in polls]


async def cut_before_commit(make_engine: Callable[[], Any],
                            polls: Sequence[int], immediate: Any) -> int:
    """Start ``make_engine()`` (built inside the running loop); at the
    i-th of ``polls[:-1]`` checkpoint epoch i + 1 and wait until every
    subtask sealed it, committing every epoch but the last; at
    ``polls[-1]`` stop with ``immediate`` (the engine package's
    ``StopMode.IMMEDIATE``) and wait for the tasks.  The last epoch's
    pre-commits stay staged.  Returns the last epoch."""
    engine = make_engine()
    running = engine.start()
    held = hold_sources(engine, polls)
    epoch = 0
    for ev in held[:-1]:
        epoch += 1
        await ev.wait()
        await running.checkpoint(epoch)
        if not await running.wait_for_checkpoint(epoch, timeout=120.0):
            raise RuntimeError(f"epoch {epoch} did not seal")
        if epoch < len(held) - 1:
            await running.commit(epoch)
    await held[-1].wait()
    await running.stop(immediate)
    await running.join()
    return epoch
