"""Async superstep scheduler: the port's copy of
``fvd_tpu/runtime/scheduler.py``.

Replaces LangGraph's Pregel loop (reference ``main.py:343`` / ``app.py:258``)
with a small asyncio scheduler:

* a node becomes runnable the moment all its parents completed (no global
  supersteps — strictly more parallel than the reference's barrier model
  while producing the same results under last-writer-wins merge);
* node functions are sync ``State -> StateDelta`` callables executed in a
  thread pool, so host-I/O nodes (web search, LLM calls) overlap with
  device-compute nodes — the reference gets this only *within* E2 via its
  ThreadPoolExecutor (``e2:326-345``);
* deltas are merged in completion order (``overwrite`` semantics,
  ``main.py:19-20``);
* every transition is emitted as a :class:`NodeEvent`, feeding the CLI
  progress line and the status board (``app.py:224-313`` analog).

``Scheduler.invoke`` is the ``app.invoke`` analog; ``Scheduler.stream``
yields events as they happen (the ``app.stream`` analog).
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Set

from fvd_tpu_torch.runtime.dag import DAG
from fvd_tpu_torch.runtime.io_pool import flush_artifacts
from fvd_tpu_torch.runtime.tracer import get_tracer
from fvd_tpu_torch.state import State, StateDelta


@dataclass
class NodeEvent:
    node: str
    status: str  # "running" | "done" | "error"
    t: float = field(default_factory=time.monotonic)
    elapsed_s: Optional[float] = None
    error: Optional[str] = None
    delta: Optional[StateDelta] = None


class NodeFailure(RuntimeError):
    def __init__(self, node: str, cause: BaseException):
        super().__init__(f"Node {node!r} failed: {cause!r}")
        self.node = node
        self.cause = cause


class Scheduler:
    """Dependency-driven executor for a :class:`DAG` over a :class:`State`."""

    def __init__(
        self,
        dag: DAG,
        max_workers: int = 8,
        on_event: Optional[Callable[[NodeEvent], None]] = None,
        fail_fast: bool = True,
        detect_conflicts: bool = False,
    ):
        dag.validate()
        self.dag = dag
        self.max_workers = max_workers
        self.on_event = on_event
        self.fail_fast = fail_fast
        #: Race detection (no reference analog — SURVEY §5 notes the
        #: reference has none): warn when two nodes with no ancestry
        #: relationship overwrite the same state field.  Under last-writer-
        #: wins merge, such a write's survival depends on completion order —
        #: almost always a graph-wiring bug.
        self.detect_conflicts = detect_conflicts
        self.conflicts: List[str] = []
        self._ancestors = self._compute_ancestors() if detect_conflicts else {}

    def _compute_ancestors(self) -> Dict[str, Set[str]]:
        order = self.dag.topological_order()
        anc: Dict[str, Set[str]] = {}
        for name in order:
            deps = self.dag.nodes[name].deps
            anc[name] = set(deps)
            for d in deps:
                anc[name] |= anc.get(d, set())
        return anc

    def _check_conflicts(self, node: str, delta: Optional[StateDelta],
                         writers: Dict[str, str]) -> None:
        if not delta:
            return
        for key in delta:
            if key in State._UNION_FIELDS:
                continue
            prev = writers.get(key)
            if prev is not None and prev != node:
                related = prev in self._ancestors.get(node, set()) or node in self._ancestors.get(prev, set())
                if not related:
                    msg = (
                        f"write conflict on state field {key!r}: {prev!r} and "
                        f"{node!r} are concurrent (no dependency edge) — the "
                        f"surviving value depends on completion order"
                    )
                    self.conflicts.append(msg)
                    print(f"Scheduler: WARNING - {msg}")
            writers[key] = node

    # ------------------------------------------------------------------
    async def arun(self, state: State) -> State:
        events: List[NodeEvent] = []

        async def sink(ev: NodeEvent):
            events.append(ev)

        return await self._drive(state, sink)

    def invoke(self, state: State) -> State:
        """Synchronous full run (the ``app.invoke`` analog, main.py:402)."""
        return asyncio.run(self.arun(state))

    def stream(self, state: State) -> Iterator[NodeEvent]:
        """Run the graph, yielding events in order (``app.stream`` analog).

        The final merged state is attached to the terminal event as
        ``delta={'__final_state__': state}``.
        """
        loop = asyncio.new_event_loop()
        queue: "asyncio.Queue[Optional[NodeEvent]]" = asyncio.Queue()

        async def sink(ev: NodeEvent):
            await queue.put(ev)

        async def runner():
            try:
                final = await self._drive(state, sink)
                await queue.put(
                    NodeEvent(node="__end__", status="done", delta={"__final_state__": final})
                )
            except Exception as e:  # surface to consumer
                await queue.put(NodeEvent(node="__end__", status="error", error=repr(e)))
            await queue.put(None)

        task = loop.create_task(runner())
        try:
            while True:
                ev = loop.run_until_complete(queue.get())
                if ev is None:
                    break
                yield ev
            loop.run_until_complete(task)
        finally:
            loop.close()

    # ------------------------------------------------------------------
    async def _drive(
        self, state: State, sink: Callable[[NodeEvent], "asyncio.Future"]
    ) -> State:
        parents = self.dag.parents()
        children = self.dag.children()
        pending: Set[str] = set(self.dag.nodes)
        done: Set[str] = set()
        running: Set[str] = set()
        failed: Dict[str, str] = {}
        tracer = get_tracer()

        loop = asyncio.get_event_loop()
        executor = ThreadPoolExecutor(
            max_workers=self.max_workers, thread_name_prefix="fvd-node"
        )
        inflight: Dict["asyncio.Future", str] = {}
        current = state
        writers: Dict[str, str] = {}

        async def emit(ev: NodeEvent):
            if self.on_event:
                self.on_event(ev)
            await sink(ev)

        def runnable() -> List[str]:
            return [
                n
                for n in self.dag.topological_order()
                if n in pending and n not in running and parents[n] <= done
            ]

        try:
            while pending:
                for name in runnable():
                    spec = self.dag.nodes[name]
                    running.add(name)
                    await emit(NodeEvent(node=name, status="running"))
                    snapshot = current  # read-only view for the node

                    def call(spec=spec, snapshot=snapshot):
                        with tracer.span(f"node/{spec.name}"):
                            return spec.fn(snapshot)

                    fut = loop.run_in_executor(executor, call)
                    inflight[fut] = name

                if not inflight:
                    if pending:
                        # Remaining nodes are blocked on failed ancestors.
                        break
                    continue

                finished, _ = await asyncio.wait(
                    list(inflight), return_when=asyncio.FIRST_COMPLETED
                )
                for fut in finished:
                    name = inflight.pop(fut)
                    running.discard(name)
                    pending.discard(name)
                    started = None
                    try:
                        delta = fut.result()
                        merged = current.apply(delta)
                    except BaseException as e:
                        failed[name] = "".join(
                            traceback.format_exception_only(type(e), e)
                        ).strip()
                        await emit(
                            NodeEvent(node=name, status="error", error=failed[name])
                        )
                        if self.fail_fast:
                            raise NodeFailure(name, e) from e
                        # skip descendants
                        self._poison_descendants(name, children, pending, failed)
                        continue
                    if self.detect_conflicts:
                        self._check_conflicts(name, delta, writers)
                    current = merged
                    done.add(name)
                    await emit(NodeEvent(node=name, status="done", delta=delta))
        finally:
            executor.shutdown(wait=False, cancel_futures=True)
            # Deferred artifact writes (viz mp4s) ran overlapped with the
            # rest of the DAG; the run isn't done until they land.
            for err in flush_artifacts(current.get("data_dir")):
                print(f"Scheduler: WARNING - deferred artifact write failed: {err}")
            # A failed deferred encode must not leave the final state
            # advertising a viz file that never landed (nodes key validity
            # on enqueue, not on the write itself).
            scrub = {
                f: None
                for f in ("mouth_landmarks_viz_path", "headpose_viz_path")
                if current.get(f) and not os.path.exists(current.get(f))
            }
            if scrub:
                current = dataclasses.replace(current, **scrub)

        if failed and self.fail_fast:
            name, err = next(iter(failed.items()))
            raise NodeFailure(name, RuntimeError(err))
        return current

    @staticmethod
    def _poison_descendants(name, children, pending, failed):
        stack = [name]
        while stack:
            n = stack.pop()
            for c in children[n]:
                if c in pending:
                    pending.discard(c)
                    failed[c] = f"skipped: ancestor {name!r} failed"
                    stack.append(c)
