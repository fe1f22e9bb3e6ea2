"""Pipeline nodes, the counterparts of ``fvd_tpu/nodes/``.

Every node is a function ``run(state: State, config: Config=...) -> StateDelta``
(bound into the DAG via ``functools.partial`` when a non-default config or
device is needed).  Nodes read the state snapshot, do host I/O and device
compute, and return only the keys they produce — the scheduler merges deltas
last-writer-wins (see ``fvd_tpu_torch/state.py``).
"""
