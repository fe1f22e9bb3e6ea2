"""Failure policy layer: the port's copy of ``fvd_tpu/runtime/retry.py``.

The reference's resilience is pervasive but ad-hoc (SURVEY §5): download
retry x3 with linear backoff (main.py:175-250), HTTP retry adapters
(e1:186-189), provider fallback chains, per-item try/except-continue.  Here
the *policies* are first-class and reusable:

* :func:`retry` — bounded retries with linear/exponential backoff and an
  optional escalation hook (the reference's OAuth2-escalation pattern,
  main.py:240-245, generalized);
* :func:`fallback_chain` — try callables in order, first success wins
  (Serper -> Google -> DDG; LLM -> heuristic);
* :func:`swallow` — per-item isolation: log and continue
  (v5:140-144, v3:129-134).
"""

from __future__ import annotations

import time
from functools import wraps
from typing import Callable, Iterable, Optional, Sequence, Tuple, Type, TypeVar

T = TypeVar("T")


class RetryExhausted(RuntimeError):
    def __init__(self, attempts: int, last: BaseException):
        super().__init__(f"failed after {attempts} attempts: {last!r}")
        self.attempts = attempts
        self.last = last


def retry(
    attempts: int = 3,
    backoff_s: float = 5.0,
    exponential: bool = False,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    escalate_on_last: Optional[Callable[[], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Decorator: bounded retries with backoff.

    ``on_retry(attempt, exc)`` fires before each wait; ``escalate_on_last``
    fires before the final attempt (credential-escalation hook).
    """

    def deco(fn: Callable[..., T]) -> Callable[..., T]:
        @wraps(fn)
        def wrapper(*args, **kwargs) -> T:
            last: Optional[BaseException] = None
            for attempt in range(1, attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:
                    last = e
                    if attempt == attempts:
                        break
                    if on_retry:
                        on_retry(attempt, e)
                    wait = backoff_s * (2 ** (attempt - 1) if exponential else attempt)
                    sleep(wait)
                    if escalate_on_last and attempt == attempts - 1:
                        escalate_on_last()
            raise RetryExhausted(attempts, last)  # type: ignore[arg-type]

        return wrapper

    return deco


def fallback_chain(
    providers: Sequence[Callable[[], T]],
    accept: Callable[[T], bool] = lambda r: bool(r),
    default: Optional[T] = None,
) -> Optional[T]:
    """Run callables in order; first acceptable result wins; exceptions fall
    through to the next provider."""
    for p in providers:
        try:
            result = p()
        except Exception:
            continue
        if accept(result):
            return result
    return default


def swallow(
    items: Iterable[T],
    fn: Callable[[T], None],
    on_error: Optional[Callable[[T, BaseException], None]] = None,
) -> int:
    """Apply fn per item, isolating failures. Returns the failure count."""
    failures = 0
    for item in items:
        try:
            fn(item)
        except Exception as e:
            failures += 1
            if on_error:
                on_error(item, e)
    return failures
