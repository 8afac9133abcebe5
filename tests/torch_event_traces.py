"""Small hand-made traces for the event-loop tests (numpy only, no JAX,
so the card-only tests can import them on a machine without JAX)."""
import numpy as np


def tie_trace(n=400, F=6):
    """Requests in groups of four at equal arrival times, equal exec
    times within a function and equal cold / evict costs: every pick
    and scan meets ties."""
    return dict(fn_id=(np.arange(n) * 7 % F).astype(np.int64),
                arrival=np.repeat(0.05 * np.arange(n // 4), 4),
                exec_time=0.1 + 0.1 * (np.arange(n) * 7 % F % 3),
                cold_start=np.full(F, 0.5), evict=np.full(F, 0.25))


def overflow_trace():
    """Twelve requests of one function, 10 ms apart, each running 1 s:
    a queue of two overflows on one slot."""
    n = 12
    return dict(fn_id=np.zeros(n, np.int64), arrival=0.01 * np.arange(n),
                exec_time=np.ones(n), cold_start=np.array([0.5]),
                evict=np.array([0.2]))
