"""The port's host runtime against the JAX package's: config, state, DAG,
scheduler, status board, retry policies and deferred artifact flushes.

Each scenario mirrors a case of ``tests/test_runtime.py``,
``tests/test_retry_policy.py`` or ``tests/test_io_pool.py`` and runs once
through each package; the test asserts the reference's expectation on both
and that the two outcomes are equal (orders, final states, errors, events,
conflict reports, board renders, call counts)."""

import dataclasses
import threading
from concurrent.futures import Future
from types import SimpleNamespace

import pytest

import fvd_tpu.config as jconfig
import fvd_tpu.runtime.dag as jdag
import fvd_tpu.runtime.io_pool as jio
import fvd_tpu.runtime.retry as jretry
import fvd_tpu.runtime.scheduler as jsched
import fvd_tpu.runtime.status as jstatus
import fvd_tpu.state as jstate
import fvd_tpu_torch.config as tconfig
import fvd_tpu_torch.runtime.dag as tdag
import fvd_tpu_torch.runtime.io_pool as tio
import fvd_tpu_torch.runtime.retry as tretry
import fvd_tpu_torch.runtime.scheduler as tsched
import fvd_tpu_torch.runtime.status as tstatus
import fvd_tpu_torch.state as tstate


def _ns(dag, sched, status, state, retry, io):
    return SimpleNamespace(DAG=dag.DAG, DAGError=dag.DAGError, Scheduler=sched.Scheduler,
                           NodeFailure=sched.NodeFailure, StatusBoard=status.StatusBoard,
                           State=state.State, merge_states=state.merge_states, retry=retry.retry,
                           RetryExhausted=retry.RetryExhausted, fallback_chain=retry.fallback_chain,
                           swallow=retry.swallow, defer_artifact=io.defer_artifact,
                           flush_artifacts=io.flush_artifacts)


PACKAGES = {"jax": _ns(jdag, jsched, jstatus, jstate, jretry, jio),
            "torch": _ns(tdag, tsched, tstatus, tstate, tretry, tio)}


def _noop(state):
    return {}


def _final(state):
    """A final state as a plain dict, for comparison across packages."""
    return {k: v for k, v in state.to_dict().items()}


# --------------------------------------------------------------- DAG scenarios
def dag_cycle(p):
    dag = p.DAG()
    dag.add_node("A", _noop)
    dag.add_node("B", _noop, deps=["A"])
    dag.add_edge("B", "A")
    with pytest.raises(p.DAGError) as e:
        dag.validate()
    return str(e.value)


def dag_unknown_dep(p):
    dag = p.DAG()
    dag.add_node("A", _noop, deps=["missing"])
    with pytest.raises(p.DAGError) as e:
        dag.validate()
    return str(e.value)


def dag_duplicate_and_unknown_edge(p):
    dag = p.DAG()
    dag.add_node("A", _noop)
    out = []
    for call in (lambda: dag.add_node("A", _noop), lambda: dag.add_edge("A", "Z"),
                 lambda: dag.add_edge("Z", "A")):
        with pytest.raises(p.DAGError) as e:
            call()
        out.append(str(e.value))
    return out


def dag_topological_order(p):
    """The full graph's wiring (``fvd_tpu/graph.py``) with no-op nodes."""
    dag = p.DAG()
    for name, deps in [("IN", []), ("A1", ["IN"]), ("V1", ["IN"]), ("A2", ["A1"]), ("A3", ["A1"]),
                       ("V2", ["V1"]), ("V3", ["V1"]), ("V4", ["V1"]), ("V5", ["V1"]),
                       ("C1", ["A3", "V3"]), ("C2", ["A2", "V1"]), ("C3", ["A2", "V2"]),
                       ("E1", ["C3"]), ("E2", ["E1"]), ("E3", ["E2"]),
                       ("LR", ["C1", "C2", "V4", "V5", "E3"])]:
        dag.add_node(name, _noop, deps=deps)
    order = dag.validate().topological_order()
    assert order.index("IN") < order.index("A1") < order.index("C1") < order.index("LR")
    return order, dag.roots(), sorted(dag.edges()), {k: sorted(v) for k, v in dag.children().items()}


# --------------------------------------------------------- scheduler scenarios
def sched_last_writer_wins(p):
    dag = p.DAG()
    dag.add_node("IN", lambda s: {"transcript": "from-IN", "word_count": 1})
    dag.add_node("A", lambda s: {"transcript": "from-A"}, deps=["IN"])
    dag.add_node("B", lambda s: {"word_count": 42}, deps=["A"])
    final = p.Scheduler(dag).invoke(p.State(input_path="x"))
    assert final.transcript == "from-A" and final.word_count == 42
    return _final(final)


def sched_parallel_branches(p):
    barrier = threading.Barrier(2, timeout=10)

    def branch(key):
        def fn(state):
            barrier.wait()  # deadlocks unless both run simultaneously
            return {key: "done"}
        return fn

    dag = p.DAG()
    dag.add_node("IN", _noop)
    dag.add_node("L", branch("transcript"), deps=["IN"])
    dag.add_node("R", branch("data_dir"), deps=["IN"])
    final = p.Scheduler(dag, max_workers=4).invoke(p.State())
    assert final.transcript == "done" and final.data_dir == "done"
    return _final(final)


def sched_node_sees_parent_output(p):
    dag = p.DAG()
    dag.add_node("IN", lambda s: {"word_count": 7})
    dag.add_node("USE", lambda s: {"onset_count": s.word_count * 2}, deps=["IN"])
    final = p.Scheduler(dag).invoke(p.State())
    assert final.onset_count == 14
    return _final(final)


def _boom(state):
    raise RuntimeError("kaput")


def sched_fail_fast(p):
    events = []
    dag = p.DAG()
    dag.add_node("IN", _noop)
    dag.add_node("BAD", _boom, deps=["IN"])
    dag.add_node("AFTER", _noop, deps=["BAD"])
    with pytest.raises(p.NodeFailure) as e:
        p.Scheduler(dag, on_event=events.append).invoke(p.State())
    return e.value.node, repr(e.value.cause), [(ev.node, ev.status, ev.error) for ev in events]


def sched_fail_soft(p):
    seen = []

    def record(state):
        seen.append("ran")
        return {"word_count": 3}

    events = []
    dag = p.DAG()
    dag.add_node("IN", _noop)
    dag.add_node("BAD", _boom, deps=["IN"])
    dag.add_node("CHILD", record, deps=["BAD"])
    dag.add_node("GRANDCHILD", record, deps=["CHILD"])
    dag.add_node("SIBLING", record, deps=["IN"])
    final = p.Scheduler(dag, fail_fast=False, on_event=events.append).invoke(p.State())
    assert seen == ["ran"]  # SIBLING ran, CHILD and GRANDCHILD skipped
    return _final(final), sorted((ev.node, ev.status, ev.error) for ev in events)


def sched_stream_events(p):
    dag = p.DAG()
    dag.add_node("IN", lambda s: {"word_count": 1})
    dag.add_node("A", lambda s: {"word_count": 2}, deps=["IN"])
    dag.add_node("B", lambda s: {"onset_count": 5}, deps=["A"])
    events = list(p.Scheduler(dag).stream(p.State()))
    names = [(e.node, e.status) for e in events]
    assert names.index(("IN", "done")) < names.index(("A", "running"))
    final_ev = events[-1]
    assert final_ev.node == "__end__" and final_ev.delta["__final_state__"].word_count == 2
    return names, [e.delta for e in events[:-1]], _final(final_ev.delta["__final_state__"])


def sched_stream_error(p):
    dag = p.DAG()
    dag.add_node("IN", _boom)
    events = list(p.Scheduler(dag).stream(p.State()))
    return [(e.node, e.status) for e in events], events[-1].error is not None


def sched_rejects_unknown_keys(p):
    dag = p.DAG()
    dag.add_node("IN", lambda s: {"not_a_field": 1})
    with pytest.raises(p.NodeFailure) as e:
        p.Scheduler(dag).invoke(p.State())
    return e.value.node, type(e.value.cause).__name__


def sched_metadata_union(p):
    dag = p.DAG()
    dag.add_node("IN", lambda s: {"metadata": {"duration": 5.0}})
    dag.add_node("A", lambda s: {"metadata": {**s.get("metadata", {}), "audio_sr": 16000}}, deps=["IN"])
    dag.add_node("B", lambda s: {"metadata": {**s.get("metadata", {}), "video_fps": 30.0}}, deps=["IN"])
    final = p.Scheduler(dag, max_workers=4).invoke(p.State())
    assert final.metadata == {"duration": 5.0, "audio_sr": 16000, "video_fps": 30.0}
    return _final(final)


def sched_metadata_same_key(p):
    dag = p.DAG()
    dag.add_node("IN", lambda s: {"metadata": {"x": 1}})
    dag.add_node("A", lambda s: {"metadata": {"x": 2}}, deps=["IN"])
    final = p.Scheduler(dag).invoke(p.State())
    assert final.metadata == {"x": 2}
    return _final(final)


def sched_conflict_concurrent(p):
    dag = p.DAG()
    dag.add_node("IN", _noop)
    dag.add_node("A", lambda s: {"transcript": "a"}, deps=["IN"])
    dag.add_node("B", lambda s: {"transcript": "b"}, deps=["IN"])  # concurrent
    sched = p.Scheduler(dag, detect_conflicts=True)
    sched.invoke(p.State())
    assert len(sched.conflicts) == 1 and "transcript" in sched.conflicts[0]
    # which of A and B finished first decides the message's word order
    return sorted(sched.conflicts[0].replace("'A'", "X").replace("'B'", "X").split())


def sched_conflict_ordered(p):
    dag = p.DAG()
    dag.add_node("IN", lambda s: {"transcript": "in"})
    dag.add_node("A", lambda s: {"transcript": "a"}, deps=["IN"])
    dag.add_node("B", lambda s: {"transcript": "b"}, deps=["A"])
    sched = p.Scheduler(dag, detect_conflicts=True)
    final = sched.invoke(p.State())
    assert sched.conflicts == []
    return sched.conflicts, _final(final)


def sched_conflict_union_fields(p):
    dag = p.DAG()
    dag.add_node("IN", _noop)
    dag.add_node("A", lambda s: {"metadata": {"a": 1}}, deps=["IN"])
    dag.add_node("B", lambda s: {"metadata": {"b": 2}}, deps=["IN"])
    sched = p.Scheduler(dag, detect_conflicts=True)
    final = sched.invoke(p.State())
    assert sched.conflicts == [] and final.metadata == {"a": 1, "b": 2}
    return sched.conflicts, _final(final)


def sched_scrubs_dead_viz_paths(p, tmp_path):
    live = tmp_path / "landmarks_viz.mp4"
    live.write_bytes(b"x")
    dag = p.DAG()
    dag.add_node("V3", lambda s: {"mouth_landmarks_viz_path": str(live)})
    dag.add_node("V4", lambda s: {"headpose_viz_path": str(tmp_path / "never_written.mp4")})
    final = p.Scheduler(dag).invoke(p.State(input_path="x"))
    assert final.mouth_landmarks_viz_path == str(live) and final.headpose_viz_path is None
    return _final(final)


def sched_flushes_deferred_writes(p, tmp_path):
    """A node's deferred artifact write is waited for when the run ends, and
    its failure is reported, not raised."""
    run_dir = str(tmp_path / "run")
    done, bad = Future(), Future()

    def node(state):
        p.defer_artifact(run_dir, done)
        p.defer_artifact(run_dir, bad)
        return {"data_dir": run_dir}

    def finish():
        done.set_result(None)
        bad.set_exception(OSError("disk full"))

    threading.Timer(0.05, finish).start()
    dag = p.DAG()
    dag.add_node("V3", node)
    final = p.Scheduler(dag).invoke(p.State())
    assert done.done() and bad.done()
    return _final(final), p.flush_artifacts(run_dir)


# ------------------------------------------------------------- state scenarios
def state_overwrite_and_merge(p):
    s = p.State(claims=[{"a": 1}], metadata={"k": 1})
    s2 = s.apply({"claims": [{"b": 2}], "metadata": {"j": 2}})
    assert s2.claims == [{"b": 2}] and s.claims == [{"a": 1}]
    s3 = p.merge_states(s, {"word_count": 1}, None, {"word_count": 2, "metadata": {"k": 3}}, {})
    return _final(s2), _final(s3), s.apply(None) is s


def state_dict_access(p):
    s = p.State.from_dict({"input_path": "v.mp4", "word_count": 0, "debug": True})
    with pytest.raises(KeyError):
        p.State.from_dict({"nope": 1})
    with pytest.raises(KeyError):
        s["nope"]
    with pytest.raises(KeyError):
        s.apply({"nope": 1})
    return (p.State.field_names(), s.get("transcript", "dflt"), s.get("word_count"), s["input_path"],
            "transcript" in s, "word_count" in s, "nope" in s, _final(s))


# ------------------------------------------------------- status board scenarios
TOY_EDGES = [("IN", "V1"), ("IN", "A1"), ("A1", "A2"), ("V1", "C2"), ("A2", "C2")]
TOY_ORDER = ["IN", "V1", "A1", "A2", "C2"]


def board_reference_semantics(p):
    board = p.StatusBoard(TOY_ORDER, TOY_EDGES)
    trace = [(sorted(board.mark_done(["IN"])), board.statuses())]
    trace.append((sorted(board.mark_done(["V1"])), board.statuses()))
    trace.append((sorted(board.mark_done(["A1"])), board.statuses()))
    assert trace[0][1]["A2"] == "queued" and trace[2][1]["A2"] == "running"
    return trace


def board_defers_out_of_order(p):
    board = p.StatusBoard(TOY_ORDER, TOY_EDGES)
    early = board.mark_done(["A2"])
    queued = board.statuses()["A2"]
    accepted = board.mark_done(["IN", "A1"])
    assert early == set() and queued == "queued" and accepted == {"IN", "A1", "A2"}
    return sorted(early), queued, sorted(accepted), board.statuses()


def board_render(p):
    board = p.StatusBoard(TOY_ORDER, TOY_EDGES)
    lines = [board.render_lines()]
    for batch in (["IN"], ["C2"], ["A1", "V1"], ["A2"]):
        board.mark_done(batch)
        lines.append(board.render_lines())
    assert lines[1][0] == "[x] IN" and "[~] V1" in lines[1]
    return lines


# ------------------------------------------------------------ retry scenarios
def retry_succeeds_after_failures(p):
    calls = []

    @p.retry(attempts=3, backoff_s=1.0, sleep=lambda s: calls.append(("sleep", s)),
             on_retry=lambda n, e: calls.append(("retry", n)))
    def flaky():
        if sum(1 for c in calls if c[0] == "try") < 2:
            calls.append(("try", None))
            raise ValueError("boom")
        return "ok"

    assert flaky() == "ok"
    assert [s for (k, s) in calls if k == "sleep"] == [1.0, 2.0]
    return calls


def retry_exhausted(p):
    n = []

    @p.retry(attempts=2, backoff_s=0.0, sleep=lambda s: None)
    def always_fails():
        n.append(1)
        raise RuntimeError("nope")

    with pytest.raises(p.RetryExhausted) as exc:
        always_fails()
    return exc.value.attempts, repr(exc.value.last), str(exc.value), len(n)


def retry_escalation_hook(p):
    events = []

    @p.retry(attempts=3, backoff_s=0.0, sleep=lambda s: None,
             escalate_on_last=lambda: events.append("escalate"))
    def fails():
        events.append("try")
        raise ValueError()

    with pytest.raises(p.RetryExhausted):
        fails()
    assert events == ["try", "try", "escalate", "try"]
    return events


def retry_exponential_backoff(p):
    waits = []

    @p.retry(attempts=4, backoff_s=1.0, exponential=True, sleep=waits.append)
    def fails():
        raise ValueError()

    with pytest.raises(p.RetryExhausted):
        fails()
    assert waits == [1.0, 2.0, 4.0]
    return waits


def retry_only_listed_exceptions(p):
    n = []

    @p.retry(attempts=3, backoff_s=0.0, retry_on=(ValueError,), sleep=lambda s: None)
    def wrong_kind():
        n.append(1)
        raise KeyError("k")

    with pytest.raises(KeyError):
        wrong_kind()
    return len(n)


def retry_fallback_chain(p):
    calls = []

    def a():
        calls.append("a")
        raise RuntimeError("down")

    def b():
        calls.append("b")
        return []  # empty -> not accepted

    def c():
        calls.append("c")
        return ["result"]

    first = p.fallback_chain([a, b, c])
    assert first == ["result"]
    return first, p.fallback_chain([lambda: []], default="d"), calls


def retry_swallow(p):
    seen, errors = [], []

    def fn(x):
        if x == 2:
            raise ValueError()
        seen.append(x)

    n = p.swallow([1, 2, 3], fn, on_error=lambda item, e: errors.append(item))
    assert (n, seen, errors) == (1, [1, 3], [2])
    return n, seen, errors


# ----------------------------------------------------------- io_pool scenario
def io_deferred_flush_per_run_dir(p, tmp_path):
    ok, bad, other = Future(), Future(), Future()
    ok.set_result(None)
    bad.set_exception(RuntimeError("viz write failed"))
    other.set_result(None)
    p.defer_artifact(str(tmp_path / "runA"), ok)
    p.defer_artifact(str(tmp_path / "runA"), bad)
    p.defer_artifact(str(tmp_path / "runB"), other)
    errs = p.flush_artifacts(str(tmp_path / "runA"))
    assert len(errs) == 1 and "viz write failed" in errs[0]
    return errs, p.flush_artifacts(str(tmp_path / "runB")), p.flush_artifacts(None)


SCENARIOS = [dag_cycle, dag_unknown_dep, dag_duplicate_and_unknown_edge, dag_topological_order,
             sched_last_writer_wins, sched_parallel_branches, sched_node_sees_parent_output,
             sched_fail_fast, sched_fail_soft, sched_stream_events, sched_stream_error,
             sched_rejects_unknown_keys, sched_metadata_union, sched_metadata_same_key,
             sched_conflict_concurrent, sched_conflict_ordered, sched_conflict_union_fields,
             state_overwrite_and_merge, state_dict_access,
             board_reference_semantics, board_defers_out_of_order, board_render,
             retry_succeeds_after_failures, retry_exhausted, retry_escalation_hook,
             retry_exponential_backoff, retry_only_listed_exceptions, retry_fallback_chain,
             retry_swallow]
TMP_SCENARIOS = [sched_scrubs_dead_viz_paths, sched_flushes_deferred_writes,
                 io_deferred_flush_per_run_dir]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_runtime_scenario_matches_jax(scenario):
    assert scenario(PACKAGES["torch"]) == scenario(PACKAGES["jax"])


@pytest.mark.parametrize("scenario", TMP_SCENARIOS, ids=lambda f: f.__name__)
def test_runtime_scenario_on_disk_matches_jax(scenario, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    got = scenario(PACKAGES["torch"], tmp_path / "torch")
    ref = scenario(PACKAGES["jax"], tmp_path / "jax")
    assert repr(got).replace(str(tmp_path / "torch"), "D") == repr(ref).replace(str(tmp_path / "jax"), "D")


@pytest.mark.parametrize("env", [None, "2", "0"])
def test_default_config_matches_jax(monkeypatch, env):
    """The whole tree and every default, and the ``E2_MAX_WORKERS`` read
    (clamped to at least 1)."""
    if env is None:
        monkeypatch.delenv("E2_MAX_WORKERS", raising=False)
    else:
        monkeypatch.setenv("E2_MAX_WORKERS", env)
    got, ref = tconfig.default_config(), jconfig.default_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.evidence.max_workers == (4 if env is None else max(1, int(env)))
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    replaced = got.replace(debug=True)
    assert replaced.debug and not got.debug
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.debug = True
