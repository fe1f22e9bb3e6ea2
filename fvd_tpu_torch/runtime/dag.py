"""Static DAG description: the port's copy of ``fvd_tpu/runtime/dag.py``.

The reference wires a LangGraph ``StateGraph`` (``main.py:292-343``).  Here a
DAG is a plain validated datastructure consumed by
:class:`fvd_tpu_torch.runtime.scheduler.Scheduler` — no framework, no Pregel loop;
just nodes, edges and a topological order check at build time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Set, Tuple

from fvd_tpu_torch.state import State, StateDelta

#: A node computes a delta from a read-only state snapshot.
NodeFn = Callable[[State], StateDelta]


@dataclass
class NodeSpec:
    name: str
    fn: NodeFn
    #: nodes whose completion gates this node
    deps: Tuple[str, ...] = ()
    #: purely-host node (I/O bound) vs device-compute node; the scheduler
    #: can overlap host nodes with device nodes across videos.
    host_only: bool = False


class DAGError(ValueError):
    pass


@dataclass
class DAG:
    nodes: Dict[str, NodeSpec] = field(default_factory=dict)

    def add_node(
        self,
        name: str,
        fn: NodeFn,
        deps: Sequence[str] = (),
        host_only: bool = False,
    ) -> "DAG":
        if name in self.nodes:
            raise DAGError(f"Duplicate node {name!r}")
        self.nodes[name] = NodeSpec(name=name, fn=fn, deps=tuple(deps), host_only=host_only)
        return self

    def add_edge(self, src: str, dst: str) -> "DAG":
        if dst not in self.nodes:
            raise DAGError(f"Unknown node {dst!r}")
        if src not in self.nodes:
            raise DAGError(f"Unknown node {src!r}")
        spec = self.nodes[dst]
        if src not in spec.deps:
            spec.deps = spec.deps + (src,)
        return self

    # ------------------------------------------------------------------
    def parents(self) -> Dict[str, Set[str]]:
        return {name: set(spec.deps) for name, spec in self.nodes.items()}

    def children(self) -> Dict[str, Set[str]]:
        out: Dict[str, Set[str]] = {name: set() for name in self.nodes}
        for name, spec in self.nodes.items():
            for dep in spec.deps:
                out[dep].add(name)
        return out

    def roots(self) -> List[str]:
        return [n for n, s in self.nodes.items() if not s.deps]

    def validate(self) -> "DAG":
        """Check all deps exist and the graph is acyclic."""
        for name, spec in self.nodes.items():
            for dep in spec.deps:
                if dep not in self.nodes:
                    raise DAGError(f"Node {name!r} depends on unknown node {dep!r}")
        self.topological_order()
        return self

    def topological_order(self) -> List[str]:
        """Kahn's algorithm; raises on cycles. Deterministic (insertion order)."""
        indeg = {n: len(s.deps) for n, s in self.nodes.items()}
        children = self.children()
        ready = [n for n in self.nodes if indeg[n] == 0]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in sorted(children[n], key=list(self.nodes).index):
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.nodes):
            cyclic = sorted(set(self.nodes) - set(order))
            raise DAGError(f"Cycle detected among nodes: {cyclic}")
        return order

    def edges(self) -> List[Tuple[str, str]]:
        return [(dep, name) for name, spec in self.nodes.items() for dep in spec.deps]
