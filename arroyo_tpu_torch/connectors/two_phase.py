"""The exactly-once sink protocol (port of
``arroyo_tpu.connectors.two_phase``).

A sink buffers writes; at each checkpoint barrier it turns them into
*pre-commit* data, persisted with the snapshot in a table written with
``WriteBehavior.COMMIT_WRITES``.  Once every subtask has sealed the
checkpoint, the runner sends a commit control message
(``RunningEngine.commit``) and the sink finalizes the pre-committed work:
it promotes staged files or commits a Kafka transaction.  A restore
re-commits the restored epoch's pre-commits before the stream resumes,
so the output is exactly once.  Each commit of an epoch is counted and
timed in ``obs.metrics.sink_commit_counters``."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..engine.context import Context
from ..engine.operator import Operator
from ..obs.metrics import sink_commit_counters
from ..state.tables import TableDescriptor, TableType, WriteBehavior
from ..types import Batch, CheckpointBarrier

# 'r': the committer's recovery state; 'p': pre-commits by epoch, awaiting
# the commit phase
RECOVERY_TABLE = "r"
PRECOMMIT_TABLE = "p"


class TwoPhaseCommitterSink(Operator):
    """Base of the exactly-once sinks.  A subclass implements:

    - ``committer_init(recovery_state, ctx)``: open connections, restore
      from the recovery state (None on a fresh start);
    - ``insert_batch(batch, ctx)``: buffer or stage a batch;
    - ``committer_checkpoint(epoch, stopping, ctx) -> (recovery,
      pre_commits)``: move staged data to its pre-committed place;
    - ``committer_commit(epoch, pre_commits, ctx)``: finalize it;
    - optionally ``committer_post_restore(ctx)``: drop staged artifacts
      no pre-commit names, once the restored ones are committed."""

    def tables(self) -> List[TableDescriptor]:
        return [
            TableDescriptor(RECOVERY_TABLE, TableType.GLOBAL,
                            "two-phase committer recovery state"),
            TableDescriptor(PRECOMMIT_TABLE, TableType.GLOBAL,
                            "pre-commit data awaiting the commit phase",
                            write_behavior=WriteBehavior.COMMIT_WRITES),
        ]

    # -- committer hooks ---------------------------------------------------------

    async def committer_init(self, recovery_state: Optional[Any],
                             ctx: Context) -> None:
        pass

    async def insert_batch(self, batch: Batch, ctx: Context) -> None:
        raise NotImplementedError

    async def committer_checkpoint(
            self, epoch: int, stopping: bool,
            ctx: Context) -> Tuple[Any, Dict[str, Any]]:
        raise NotImplementedError

    async def committer_commit(self, epoch: int, pre_commits: Dict[str, Any],
                               ctx: Context) -> None:
        raise NotImplementedError

    async def committer_post_restore(self, ctx: Context) -> None:
        """Runs after the restored pre-commits were re-committed: what is
        still staged belongs to an epoch that never sealed."""

    # -- operator plumbing ---------------------------------------------------------

    async def _commit(self, epoch: int, pending: Dict[str, Any],
                      ctx: Context) -> None:
        t0 = time.perf_counter()
        await self.committer_commit(epoch, pending, ctx)
        epochs, precommits, seconds = self._commit_metrics
        seconds.inc(time.perf_counter() - t0)
        epochs.inc()
        precommits.inc(len(pending))

    async def on_start(self, ctx: Context) -> None:
        self._commit_metrics = sink_commit_counters(ctx.task_info)
        # pre-commits are keyed by epoch, so a commit of epoch N never
        # finalizes epoch N + 1's unsealed work
        pre = ctx.state.get_global_keyed_state(PRECOMMIT_TABLE)
        rec = ctx.state.get_global_keyed_state(RECOVERY_TABLE)
        await self.committer_init(rec.get("state"), ctx)
        if ctx.state.restore_epoch is not None:
            # the restored checkpoint was sealed, so its pre-commits
            # belong to it and must become visible
            for epoch, pending in sorted(pre.get_all().items()):
                if pending:
                    await self._commit(epoch, pending, ctx)
                pre.remove(epoch)
        await self.committer_post_restore(ctx)

    async def process_batch(self, batch: Batch, ctx: Context,
                            side: int = 0) -> None:
        await self.insert_batch(batch, ctx)

    async def pre_checkpoint(self, barrier: CheckpointBarrier,
                             ctx: Context) -> None:
        recovery, pre_commits = await self.committer_checkpoint(
            barrier.epoch, barrier.then_stop, ctx)
        ctx.state.get_global_keyed_state(RECOVERY_TABLE).insert(
            "state", recovery)
        if pre_commits:
            ctx.state.get_global_keyed_state(PRECOMMIT_TABLE).insert(
                barrier.epoch, pre_commits)

    def has_pending_commits(self, ctx: Context) -> bool:
        return len(ctx.state.get_global_keyed_state(PRECOMMIT_TABLE)) > 0

    async def handle_commit(self, epoch: int, ctx: Context) -> None:
        pre = ctx.state.get_global_keyed_state(PRECOMMIT_TABLE)
        for e, pending in sorted(pre.get_all().items()):
            if e <= epoch:
                if pending:
                    await self._commit(e, pending, ctx)
                pre.remove(e)
