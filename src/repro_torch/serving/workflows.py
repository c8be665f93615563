"""Agentic workflow generators + driver (paper §7.1 methodology; port of
``repro/serving/workflows.py``).

ReAct: sequential pipeline — each agent's context = shared static prefix +
all previous agents' outputs + mock tool observations + its own instruction.
MapReduce: N agents fork the same shared context in parallel with distinct
instructions; a reduce agent consumes their concatenated outputs.

Tool calls are simulated exactly as in the paper: a constant latency and a
mock observation of random tokens (synthetic ids here — no tokenizer ships
offline).

The driver runs entirely on the session/fork API (DESIGN.md §11): one
:class:`~repro_torch.serving.api.AgentSession` pins the shared static
context, every agent step is a ``session.fork()``, and the engine is pumped
through ``server.poll()`` — no ``Request`` construction or ``engine.step()``
busy loops here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.api import ForkServer, GenerationHandle
from repro_torch.serving.engine import Engine
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass
class WorkflowConfig:
    n_workflows: int = 4
    agents_per_workflow: int = 4
    rounds: int = 1               # ReAct rounds: each agent revisits its
                                  # (grown) context every round — the
                                  # paper's sustained multi-turn load
    shared_context_len: int = 512     # paper: 32K-64K; scaled for CPU
    instr_len: int = 24               # paper Table 1: ~24 dynamic tokens
    tool_obs_len: int = 50            # paper: 100 mock tool tokens
    max_new_tokens: int = 16          # paper: 256; scaled for CPU
    tool_latency_s: float = 0.0       # simulated (recorded, not slept)
    vocab: int = 1024
    seed: int = 0
    # token-selection policy for every agent; None -> greedy argmax with
    # this config's max_new_tokens budget
    sampling: Optional[SamplingParams] = None


class WorkflowDriver:
    """Drives ReAct / MapReduce workflows through a :class:`ForkServer`.

    Accepts a bare :class:`Engine` too (wrapped via ``from_engine``) so
    engine-level tests and older callers keep working.
    """

    def __init__(self, server, wf: WorkflowConfig):
        if isinstance(server, Engine):
            server = ForkServer.from_engine(server)
        self.server: ForkServer = server
        self.engine = server.engine        # metrics convenience
        self.wf = wf
        self.rng = np.random.default_rng(wf.seed)
        # one shared static context per workflow "project"; workflows within
        # a run share it (the paper's massive static part)
        self.shared = list(self.rng.integers(
            0, wf.vocab, size=wf.shared_context_len).astype(int))
        self.tool_time = 0.0

    def _tokens(self, n: int) -> List[int]:
        return list(self.rng.integers(0, self.wf.vocab, size=n).astype(int))

    def _sampling(self) -> SamplingParams:
        if self.wf.sampling is not None:
            return self.wf.sampling
        return SamplingParams(max_new_tokens=self.wf.max_new_tokens)

    # ------------------------------------------------------------- ReAct
    def run_react(self) -> Dict:
        """CONCURRENT sequential workflows (paper §7.1: N workflows run at
        once; within a workflow agents chain).  Agent i of workflow w uses
        adapter w*agents+i (completely non-overlapping adapters, Fig. 3).
        Concurrency is what creates the memory pressure + decode batching
        the paper measures."""
        wf = self.wf
        t0 = time.time()
        tasks = 0
        total_steps = wf.agents_per_workflow * wf.rounds
        session = self.server.session(self.shared)
        state = [{"dynamic": [], "agent": 0, "handle": None}
                 for _ in range(wf.n_workflows)]

        def unfinished():
            return any(s["agent"] < total_steps or
                       s["handle"] is not None for s in state)

        while unfinished():
            for w, s in enumerate(state):
                if s["handle"] is None and s["agent"] < total_steps:
                    # agents cycle across rounds: same adapter re-extends
                    # the same (grown) context -> residual-tree hits
                    adapter = w * wf.agents_per_workflow + \
                        (s["agent"] % wf.agents_per_workflow)
                    instr = s["dynamic"] + self._tokens(wf.instr_len)
                    s["handle"] = session.fork(adapter, instr,
                                               self._sampling())
            self.server.poll()
            for s in state:
                h: Optional[GenerationHandle] = s["handle"]
                if h is not None and h.done:
                    out = h.result().tokens
                    s["dynamic"] = s["dynamic"] + out + \
                        self._tokens(wf.tool_obs_len)
                    s["agent"] += 1
                    s["handle"] = None
                    self.tool_time += wf.tool_latency_s
                    tasks += 1
        session.close()
        wall = time.time() - t0
        return self._report("react", tasks, wall)

    # --------------------------------------------------------- MapReduce
    def run_mapreduce(self) -> Dict:
        """Parallel map agents fork the shared context simultaneously."""
        wf = self.wf
        t0 = time.time()
        tasks = 0
        session = self.server.session(self.shared)
        for w in range(wf.n_workflows):
            handles = []
            for a in range(wf.agents_per_workflow):
                adapter = w * wf.agents_per_workflow + a
                handles.append(session.fork(
                    adapter, self._tokens(wf.instr_len), self._sampling()))
            outs = [r.tokens for r in self.server.wait(handles)]
            tasks += len(handles)
            # reduce step: one agent over concatenated outputs
            reduce_instr = [t for o in outs for t in o] + \
                self._tokens(wf.instr_len)
            session.fork(wf.n_workflows * wf.agents_per_workflow + w,
                         reduce_instr, self._sampling()).result()
            tasks += 1
        session.close()
        wall = time.time() - t0
        return self._report("mapreduce", tasks, wall)

    def _report(self, kind: str, tasks: int, wall: float) -> Dict:
        m = self.server.metrics()
        m.update(workflow=kind, tasks=tasks, wall_s=wall,
                 tool_latency_s=self.tool_time,
                 throughput_tasks_per_s=tasks / max(wall, 1e-9))
        return m
