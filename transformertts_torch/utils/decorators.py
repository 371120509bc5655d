"""Resilience decorators (reference: utils/decorators.py:5-30)."""
import time
import traceback
from functools import wraps


def ignore_exception(fn):
    """Logging/diagnostics must never kill a training run."""
    @wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            print(f'ignored exception in {fn.__name__}:')
            traceback.print_exc()
            return None
    return wrapper


def time_it(fn):
    """Returns (result, elapsed_seconds)."""
    @wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        return result, time.perf_counter() - t0
    return wrapper
