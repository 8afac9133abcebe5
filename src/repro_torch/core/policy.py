"""Scheduling-policy interface.

A policy owns its queue structures and reacts to four simulator hooks.
The :class:`~repro_torch.core.server.EdgeServer` provides the slot primitives
(``dispatch`` / ``start_cold`` / ``make_idle``); the policy provides the
*decisions* (paper Algorithms 1-3 and the baselines of §VI-A).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List

from repro_torch.core.request import FunctionProfile, Request
from repro_torch.core.server import EdgeServer, ExecTimeEstimator, Instance
from repro_torch.utils.registry import Registry

POLICIES = Registry("scheduling policies")


class Policy:
    name = "base"

    def bind(self, server: EdgeServer, estimator: ExecTimeEstimator) -> None:
        self.server = server
        self.est = estimator
        self.functions: List[FunctionProfile] = server.functions

    # -- convenience shared by per-function-queue policies ---------------
    def _init_fn_queues(self) -> None:
        self.queues: Dict[int, Deque[Request]] = {
            f.fn_id: deque() for f in self.functions
        }

    # hooks ---------------------------------------------------------------
    def on_arrival(self, req: Request, t: float) -> None:
        raise NotImplementedError

    def on_cold_done(self, inst: Instance, t: float) -> None:
        raise NotImplementedError

    def on_exec_done(self, inst: Instance, req: Request, t: float) -> None:
        raise NotImplementedError

    def on_timer(self, payload, t: float) -> None:  # only OpenWhisk V2 uses it
        pass
